// Exact softmax attention backward, bf16 in and out: dQ, dK, dV.
//
// Replaces the Pallas kernel clip_embeds_tpu/ops/flash_attention.py
// `_attn_bwd_kernel` (wired in by `_flash_attention_bwd_impl` and the
// custom VJP's `_bwd`). Per (b*h, Q tile) the TPU kernel recomputes P from
// (q, k), and accumulates dK and dV across Q tiles in output blocks that
// the sequential TPU grid revisits. Blocks of a Hopper grid run in parallel
// and in no order, so here the work is two launches with no atomics, which
// also makes the result deterministic:
//
//   (1) dQ: one warpgroup per (b*h, 64-row Q tile). Its prologue loads the
//       Q, dO and O tiles by TMA, takes delta = rowsum(dO * O) for its rows
//       and stores it, with the forward's log-sum-exp in log2 units, to an
//       fp32 scratch of 64-row tiles for (2). Then over a TMA ring of K/V
//       tiles: S = Q K^T and dP = dO V^T, P = exp(S scale - lse),
//       dS = P (dP - delta) scale, dQ += dS(bf16) K.
//   (2) dK, dV: one warpgroup per (b*h, 64-key tile). K and V are loaded
//       once; over a TMA ring of (Q, dO) tiles with their lse and delta
//       (bulk copies from the scratch), from the key tile on when causal:
//       S^T = K Q^T and dP^T = V dO^T, P^T and dS^T, dV += P^T(bf16) dO,
//       dK += dS^T(bf16) Q.
//
// Every product is a wgmma: the first two of a tile read both operands
// from shared memory (B K-major), the accumulating ones take A (P or dS,
// packed to bf16 straight from the fp32 accumulator) from registers and B
// MN-major from the same swizzled tile; S, P, dP, dS and the dQ, dK and dV
// accumulators never leave registers, and the results go out by TMA store
// once. At D = 128 the Q sub-tile of (2) is 32 rows (wgmma n = 32), so
// that dK, dV, S^T and dP^T fit the register file. P and dS are rounded to
// bf16 before their products, as the Pallas kernel rounds them to the input
// dtype; sums are fp32, cast to bf16 once. Masked (q, k) pairs (key >=
// kv_valid, key > query when causal, padded rows) get P = 0; the maps of K
// and V end at kv_valid, so TMA zero-fills the keys past it. Q, K, V, O and
// dO are read through their strides, so views of the packed [B, n, 3d] qkv
// buffer cost no copy.
//
// Bound: 10 N^2 D FLOPs per head (the Pallas cost estimate: 2 N^2 D for
// each of S, dP, dV, dK and dQ) against 8 N D bf16 values of IO; at ViT-L
// (N = 577, D = 64) far above the bf16 ridge, so the tensor cores bound it.
// S and dP are computed in both launches (14 N^2 D FLOPs done for the 10
// counted) in exchange for no atomics and no cross-block reduction.

#include "hopper.cuh"

namespace cet {
namespace {

constexpr int kBT = 64;  // rows of a dQ tile, of a key tile, of a scratch tile
constexpr float kLog2e = 1.4426950408889634f;

struct BwdMaps {
  CUtensorMap q, g, o, k, v;  // 64-row boxes (g = dO); k, v end at kv_valid
  CUtensorMap qs, gs;         // the dK/dV launch's Q and dO sub-tiles
  CUtensorMap dq, dk, dv;     // stores
};

struct BwdArgs {
  float* scratch;  // fp32 [B*H, tiles, 2, 64]: lse (log2 units), delta
  const float* lse;
  int H, n, kv_lim, causal, tiles;
  float scale, scale_log2;
};

template <int D>
struct DqSmem {
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr uint32_t kTile = Tile<D>::bytes(kBT);
  static constexpr uint32_t q = 0, g = kTile, o = 2 * kTile;  // o: then dQ
  static constexpr uint32_t k = 3 * kTile;
  static constexpr uint32_t v = k + kStages * kTile;
  static constexpr uint32_t lse = v + kStages * kTile;  // fp32 [64]
  static constexpr uint32_t delta = lse + 4 * kBT;       // fp32 [64]
  static constexpr uint32_t bar = delta + 4 * kBT;       // full, empty, QdO
  static constexpr uint32_t bytes = bar + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
struct DkvSmem {
  static constexpr int kBQ = D == 128 ? 32 : 64;  // Q rows of a ring tile
  static constexpr int kStages = 3;
  static constexpr uint32_t kKV = Tile<D>::bytes(kBT);
  static constexpr uint32_t kQ = Tile<D>::bytes(kBQ);
  static constexpr uint32_t k = 0, v = kKV;  // then dK, dV
  static constexpr uint32_t q = 2 * kKV;
  static constexpr uint32_t g = q + kStages * kQ;
  static constexpr uint32_t ld = g + kStages * kQ;  // per stage lse, delta
  static constexpr uint32_t bar = ld + kStages * 8 * kBQ;  // full, empty, KV
  static constexpr uint32_t bytes = bar + (2 * kStages + 1) * 8 + 1024;
};

// (1) dQ of one (b*h, 64-row Q tile), and the scratch for (2).
template <int D>
__global__ void __launch_bounds__(128, 2)
attention_bwd_dq_kernel(const __grid_constant__ BwdMaps maps, BwdArgs a) {
  using L = DqSmem<D>;
  using T = Tile<D>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int bh = blockIdx.x / a.tiles, b = bh / a.H, h = bh % a.H;
  const int qt = blockIdx.x % a.tiles, q0 = qt * kBT, n = a.n;
  const int kv_end = a.causal ? min(a.kv_lim, q0 + kBT) : a.kv_lim;
  const int tiles = kv_end > 0 ? (kv_end + kBT - 1) / kBT : 0;

  auto load_kv = [&](int j) {  // thread 0: key tile j into stage j % S
    const int s = j % S;
    mbar_expect_tx(&full[s], 2 * L::kTile);
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
      tma_load(smem + L::k + s * L::kTile + p * T::panel(kBT), &maps.k,
               &full[s], p * T::kPW, j * kBT, h, b);
      tma_load(smem + L::v + s * L::kTile + p * T::panel(kBT), &maps.v,
               &full[s], p * T::kPW, j * kBT, h, b);
    }
  };
  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(qbar, 3 * L::kTile);
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
      const int c0 = p * T::kPW, off = p * T::panel(kBT);
      tma_load(smem + L::q + off, &maps.q, qbar, c0, q0, h, b);
      tma_load(smem + L::g + off, &maps.g, qbar, c0, q0, h, b);
      tma_load(smem + L::o + off, &maps.o, qbar, c0, q0, h, b);
    }
    for (int j = 0; j < min(S, tiles); ++j) load_kv(j);
  }
  if (t < kBT) {
    const int row = q0 + t;
    lse_s[t] = row < n ? a.lse[static_cast<long long>(bh) * n + row] * kLog2e
                       : INFINITY;  // padded rows: P = 0
  }
  mbar_wait(qbar, 0);
  {  // delta = rowsum(dO * O): two threads a row (padded rows read zeros)
    const int row = t / 2, part = t % 2;
    float sum = 0.f;
#pragma unroll
    for (int ch = part * D / 16; ch < (part + 1) * D / 16; ++ch) {
      const uint32_t off = T::offset(kBT, row, ch * 8);
      const uint4 gv = *reinterpret_cast<const uint4*>(smem + L::g + off);
      const uint4 ov = *reinterpret_cast<const uint4*>(smem + L::o + off);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 gf = __bfloat1622float2(g2[e]);
        const float2 of = __bfloat1622float2(o2[e]);
        sum += gf.x * of.x + gf.y * of.y;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (part == 0) delta_s[row] = sum;
  }
  __syncthreads();  // O is read: its tile takes dQ at the end
  if (t < kBT) {
    float* out =
        a.scratch + (static_cast<long long>(bh) * a.tiles + qt) * 2 * kBT;
    out[t] = lse_s[t];
    out[kBT + t] = delta_s[t];
  }

  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
  const float lse_r[2] = {lse_s[r], lse_s[r + 8]};
  const float delta_r[2] = {delta_s[r], delta_s[r + 8]};
  const uint32_t sq = smem_u32(smem + L::q), sg = smem_u32(smem + L::g);
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    const int s = j % S, k0 = j * kBT;
    const uint32_t sk = smem_u32(smem + L::k + s * L::kTile);
    const uint32_t sv = smem_u32(smem + L::v + s * L::kTile);
    mbar_wait(&full[s], (j / S) & 1);
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBT>(sc, desc_k<D>(sq, kBT, 0, kk), desc_k<D>(sk, kBT, 0, kk),
                    kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBT>(dp, desc_k<D>(sg, kBT, 0, kk), desc_k<D>(sv, kBT, 0, kk),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge =
        k0 + kBT > a.kv_lim || (a.causal && k0 + kBT - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i >> 1) & 1;
      float p = exp2f(sc[i] * a.scale_log2 - lse_r[e]);
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + c + (i & 1);
        if (col >= a.kv_lim || (a.causal && col > q0 + r + 8 * e)) p = 0.f;
      }
      sc[i] = p * (dp[i] - delta_r[e]) * a.scale;  // dS
    }
    uint32_t da[kBT / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) acc_to_a(sc, kk, da[kk]);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk)
      wgmma_rs<D>(dq, da[kk], desc_mn<D>(sk, kBT, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(da);
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (t == 0 && j + S < tiles) {
      mbar_wait(&empty[s], (j / S) & 1);
      load_kv(j + S);
    }
    __syncwarp();
  }

  acc_to_tile<D>(smem + L::o, kBT, 0, dq, 1.f, 1.f);
  fence_async_smem();
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
      tma_store(&maps.dq, smem + L::o + p * T::panel(kBT), p * T::kPW, q0, h,
                b);
    tma_store_wait();
  }
}

// (2) dK and dV of one (b*h, 64-key tile).
template <int D>
__global__ void __launch_bounds__(128, 2)
attention_bwd_dkdv_kernel(const __grid_constant__ BwdMaps maps, BwdArgs a) {
  using L = DkvSmem<D>;
  using T = Tile<D>;
  constexpr int S = L::kStages, BQ = L::kBQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + S;
  uint64_t* kvbar = empty + S;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int bh = blockIdx.x / a.tiles, b = bh / a.H, h = bh % a.H;
  const int k0 = (blockIdx.x % a.tiles) * kBT, n = a.n;
  // causal: the Q rows before k0 see none of these keys
  const int q_begin = a.causal ? k0 : 0;
  const int steps = k0 < a.kv_lim ? (n - q_begin + BQ - 1) / BQ : 0;
  const float* scratch =
      a.scratch + static_cast<long long>(bh) * a.tiles * 2 * kBT;

  auto load_q = [&](int j) {  // thread 0: Q/dO sub-tile j into stage j % S
    const int s = j % S, q0 = q_begin + j * BQ;
    mbar_expect_tx(&full[s], 2 * L::kQ + 8 * BQ);
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
      const int off = s * L::kQ + p * T::panel(BQ);
      tma_load(smem + L::q + off, &maps.qs, &full[s], p * T::kPW, q0, h, b);
      tma_load(smem + L::g + off, &maps.gs, &full[s], p * T::kPW, q0, h, b);
    }
    const float* src = scratch + (q0 / kBT) * 2 * kBT + q0 % kBT;
    float* dst = reinterpret_cast<float*>(smem + L::ld) + s * 2 * BQ;
    bulk_load(dst, src, 4 * BQ, &full[s]);                 // lse
    bulk_load(dst + BQ, src + kBT, 4 * BQ, &full[s]);      // delta
  };
  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0 && steps > 0) {
    mbar_expect_tx(kvbar, 2 * L::kKV);
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
      const int off = p * T::panel(kBT);
      tma_load(smem + L::k + off, &maps.k, kvbar, p * T::kPW, k0, h, b);
      tma_load(smem + L::v + off, &maps.v, kvbar, p * T::kPW, k0, h, b);
    }
    for (int j = 0; j < min(S, steps); ++j) load_q(j);
  }

  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
  const uint32_t sk = smem_u32(smem + L::k), sv = smem_u32(smem + L::v);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (steps > 0) mbar_wait(kvbar, 0);

  for (int j = 0; j < steps; ++j) {
    const int s = j % S, q0 = q_begin + j * BQ;
    const uint32_t sq = smem_u32(smem + L::q + s * L::kQ);
    const uint32_t sg = smem_u32(smem + L::g + s * L::kQ);
    const float* lse_s =
        reinterpret_cast<const float*>(smem + L::ld) + s * 2 * BQ;
    const float* delta_s = lse_s + BQ;
    mbar_wait(&full[s], (j / S) & 1);
    float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: keys x queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(st, desc_k<D>(sk, kBT, 0, kk), desc_k<D>(sq, BQ, 0, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(dpt, desc_k<D>(sv, kBT, 0, kk), desc_k<D>(sg, BQ, 0, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    const bool edge =
        k0 + kBT > a.kv_lim || (a.causal && q0 < k0 + kBT - 1);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int col = 8 * (i >> 2) + c + (i & 1);  // query within the tile
      float p = exp2f(st[i] * a.scale_log2 - lse_s[col]);
      if (edge) {
        const int key = k0 + r + 8 * ((i >> 1) & 1);
        if (key >= a.kv_lim || (a.causal && key > q0 + col)) p = 0.f;
      }
      st[i] = p;
      dpt[i] = p * (dpt[i] - delta_s[col]) * a.scale;  // dS^T
    }
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(st, kk, pa[kk]);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], desc_mn<D>(sg, BQ, kk), 1);
    wgmma_commit();
    // dS^T while dV's products run (their A registers, pa, stay untouched)
    uint32_t da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(dpt, kk, da[kk]);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dk, da[kk], desc_mn<D>(sq, BQ, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(da);
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (t == 0 && j + S < steps) {
      mbar_wait(&empty[s], (j / S) & 1);
      load_q(j + S);
    }
    __syncwarp();
  }

  // dK and dV through the K and V tiles (keys past kv_valid store zeros)
  acc_to_tile<D>(smem + L::k, kBT, 0, dk, 1.f, 1.f);
  acc_to_tile<D>(smem + L::v, kBT, 0, dv, 1.f, 1.f);
  fence_async_smem();
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
      const int off = p * T::panel(kBT);
      tma_store(&maps.dk, smem + L::k + off, p * T::kPW, k0, h, b);
      tma_store(&maps.dv, smem + L::v + off, p * T::kPW, k0, h, b);
    }
    tma_store_wait();
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* g, void* dq, void* dk, void* dv, BwdArgs a, int B,
               long long sb, long long sh, long long sn, long long ob,
               long long oh, long long on, long long gb, long long gh,
               long long gn, long long xb, long long xh, long long xn,
               cudaStream_t stream) {
  using T = Tile<D>;
  const int dq_bytes = static_cast<int>(DqSmem<D>::bytes);
  const int dkv_bytes = static_cast<int>(DkvSmem<D>::bytes);
  cudaError_t e = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int H = a.H, n = a.n, kvr = std::max(a.kv_lim, 1), bq = DkvSmem<D>::kBQ;
  const int w = T::kPW, sw = T::kSwz;
  BwdMaps m;
  int err = make_map(&m.q, q, D, n, H, B, sn, sh, sb, w, kBT, sw);
  if (!err) err = make_map(&m.g, g, D, n, H, B, gn, gh, gb, w, kBT, sw);
  if (!err) err = make_map(&m.o, o, D, n, H, B, on, oh, ob, w, kBT, sw);
  if (!err) err = make_map(&m.k, k, D, kvr, H, B, sn, sh, sb, w, kBT, sw);
  if (!err) err = make_map(&m.v, v, D, kvr, H, B, sn, sh, sb, w, kBT, sw);
  if (!err) err = make_map(&m.qs, q, D, n, H, B, sn, sh, sb, w, bq, sw);
  if (!err) err = make_map(&m.gs, g, D, n, H, B, gn, gh, gb, w, bq, sw);
  if (!err) err = make_map(&m.dq, dq, D, n, H, B, xn, xh, xb, w, kBT, sw);
  if (!err) err = make_map(&m.dk, dk, D, n, H, B, xn, xh, xb, w, kBT, sw);
  if (!err) err = make_map(&m.dv, dv, D, n, H, B, xn, xh, xb, w, kBT, sw);
  if (err) return err;
  // b*h and the tile folded into x: no 65535 limit
  const int grid = B * H * a.tiles;
  attention_bwd_dq_kernel<D><<<grid, 128, dq_bytes, stream>>>(m, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_dkdv_kernel<D><<<grid, 128, dkv_bytes, stream>>>(m, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cet

// q, k, v: [B, H, n, D] through strides (sb, sh, sn); o, dO through
// (ob, oh, on) and (gb, gh, gn); lse: the forward's fp32 [B*H, n]; scratch:
// fp32 [B*H, 2 * 64 * ceil(n / 64)]; dq, dk, dv: bf16 outputs through
// (xb, xh, xn).
extern "C" int cet_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int H, int n, int D, int kv_valid, int causal,
    float scale, long long sb, long long sh, long long sn, long long ob,
    long long oh, long long on, long long gb, long long gh, long long gn,
    long long xb, long long xh, long long xn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cet::BwdArgs a{static_cast<float*>(scratch), static_cast<const float*>(lse),
                 H, n, std::max(0, std::min(n, kv_valid)), causal,
                 (n + cet::kBT - 1) / cet::kBT, scale, scale * cet::kLog2e};
  switch (D) {
    case 32:
      return cet::launch_bwd<32>(q, k, v, o, dout, dq, dk, dv, a, B, sb, sh,
                                 sn, ob, oh, on, gb, gh, gn, xb, xh, xn, s);
    case 64:
      return cet::launch_bwd<64>(q, k, v, o, dout, dq, dk, dv, a, B, sb, sh,
                                 sn, ob, oh, on, gb, gh, gn, xb, xh, xn, s);
    case 128:
      return cet::launch_bwd<128>(q, k, v, o, dout, dq, dk, dv, a, B, sb, sh,
                                  sn, ob, oh, on, gb, gh, gn, xb, xh, xn, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
