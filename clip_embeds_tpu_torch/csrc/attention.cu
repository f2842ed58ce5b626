// Exact softmax attention forward, bf16 in and out (the backward is
// attention_bwd.cu).
//
// Replaces the Pallas kernels clip_embeds_tpu/ops/flash_attention.py
// `flash_attention` forward (`_attn_kernel`) and the attention step of
// clip_embeds_tpu/ops/fused_block.py `_kernel` (`_attention`). The TPU
// kernel holds all of K/V for one (batch, head) in VMEM and takes one exact
// row softmax per Q tile; the fused block's non-causal path also skips the
// row max behind a logit clamp at 75. Neither carries over: here one block
// owns one (b*h, 128-row Q tile) and walks 64-key K/V tiles with the online
// max softmax (fp32 logits and running sums, P rounded to bf16 for P.V,
// fp32 accumulation), which is exact for any logit and needs no clamp.
//
// Bound: at ViT-L (N = 577, D = 64) the kernel does 4 N^2 D FLOPs per head
// on 4 N D bf16 values of IO, far above the bf16 ridge, so it is bound by
// the tensor cores and by how well their work overlaps the softmax. Design:
// - two consumer warpgroups of 64 query rows each; thread 0 also produces:
//   it loads the Q tile once and a ring of kStages K/V tiles by TMA
//   (128-byte swizzle at D = 64, two 128-byte panels at D = 128, 64-byte at
//   D = 32), one "full" and one "empty" mbarrier per stage, so the loads of
//   the next tiles are in flight while one computes;
// - S = Q K^T by wgmma m64n64k16 from shared memory (both K-major); the
//   online softmax runs on the accumulator registers (each thread holds two
//   rows; row max and sum over the quad by two shuffles), exp2 with a
//   log2(e)-prescaled scale; masks only on the last key tile and on tiles
//   that cross the diagonal; tiles wholly above it are skipped;
// - O += P V by wgmma m64nDk16 with P packed to bf16 straight from the S
//   accumulator (A from registers) and V MN-major from the same tile; O
//   stays in registers for the whole key loop, is normalised once and goes
//   out by TMA store through the Q tile's shared memory.
// Head dims: any multiple of 8 up to 128. The kernel is instantiated for
// tile head dims D = 32, 64 and 128 and runs the smallest that holds the
// logical head dim `hd`: the tensor maps end at hd columns, so TMA zero-fills
// the tile's columns past it in Q, K and V (q.k and P.V are exact) and drops
// them from the stored O; Q K^T skips the k16 steps that hold only zeros.
// The wrapper scales the logits by 1/sqrt(hd). So hd = 72 (SigLIP SO400M),
// 80, 88 or 104 reads a packed qkv buffer in place, with no padded copy.
// Masking: keys at or past kv_valid (the K/V maps end there, so TMA
// zero-fills them and padded activations never enter P V), and key > query
// when causal. Strides let one kernel read Q, K and V out of the packed
// [B, n, 3d] qkv buffer of the fused block (head g at columns g*hd,
// d + g*hd, 2d + g*hd) or out of [B, H, N, D] tensors, and write either
// [B, n, d] or [B, H, N, D]. With a non-null `lse` the kernel also writes
// each row's natural log-sum-exp of its scaled logits (fp32 [B*H, n], +inf
// for a row with no valid key), which the backward reads to recompute P;
// the serving chain of fused_block passes null and skips the store.

#include "hopper.cuh"

namespace cet {
namespace {

constexpr int kBM = 128, kBN = 64;  // query rows of a block, keys of a tile
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

struct FwdMaps {
  CUtensorMap q, k, v, o;
};

template <int D>
struct FwdSmem {
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr uint32_t kKV = Tile<D>::bytes(kBN);
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + Tile<D>::bytes(kBM);
  static constexpr uint32_t v = k + kStages * kKV;
  static constexpr uint32_t bar = v + kStages * kKV;  // full, empty, Q
  static constexpr uint32_t bytes = bar + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(256, D <= 64 ? 2 : 1)
attention_kernel(const __grid_constant__ FwdMaps maps, float* __restrict__ lse,
                 int H, int n, int kv_lim, int causal, float scale_log2,
                 int q_tiles, int k_steps) {
  using L = FwdSmem<D>;
  using T = Tile<D>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = t % 32, warp = t / 32;
  const int bh = blockIdx.x / q_tiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % q_tiles) * kBM;
  const int kv_end = causal ? min(kv_lim, q0 + kBM) : kv_lim;
  const int tiles = kv_end > 0 ? (kv_end + kBN - 1) / kBN : 0;

  auto load_kv = [&](int j) {  // thread 0: tile j into stage j % S
    const int s = j % S;
    mbar_expect_tx(&full[s], 2 * L::kKV);
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p) {
      tma_load(smem + L::k + s * L::kKV + p * T::panel(kBN), &maps.k,
               &full[s], p * T::kPW, j * kBN, h, b);
      tma_load(smem + L::v + s * L::kKV + p * T::panel(kBN), &maps.v,
               &full[s], p * T::kPW, j * kBN, h, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, T::bytes(kBM));
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
      tma_load(smem + L::q + p * T::panel(kBM), &maps.q, qbar, p * T::kPW, q0,
               h, b);
    for (int j = 0; j < min(S, tiles); ++j) load_kv(j);
  }

  // this warpgroup's rows: row0 + r and row0 + r + 8 for each thread
  const int row0 = q0 + 64 * wg, r = 16 * warp + lane / 4, c = 2 * (lane % 4);
  const int wg_end = causal ? min(kv_lim, row0 + 64) : kv_lim;
  const uint32_t sq = smem_u32(smem + L::q);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // log2 units

  mbar_wait(qbar, 0);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % S, k0 = j * kBN;
    const uint32_t sk = smem_u32(smem + L::k + s * L::kKV);
    const uint32_t sv = smem_u32(smem + L::v + s * L::kKV);
    mbar_wait(&full[s], (j / S) & 1);
    if (k0 < wg_end) {  // else every key of the tile is above the diagonal
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // past k_steps: zero columns
        if (kk < k_steps)
          wgmma_ss<kBN>(sc, desc_k<D>(sq, kBM, 64 * wg, kk),
                        desc_k<D>(sk, kBN, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool edge = k0 + kBN > kv_lim || (causal && k0 + kBN - 1 > row0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * (i >> 2) + c + (i & 1);
          const int row = row0 + r + 8 * ((i >> 1) & 1);
          if (col >= kv_lim || (causal && col > row)) x = -INFINITY;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float sub[2], alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        sub[e] = mx[e] == -INFINITY ? 0.f : mx[e];  // no valid key yet
        alpha[e] = exp2f(m[e] - sub[e]);
        m[e] = mx[e];
        l[e] *= alpha[e];  // this thread's share of the row sum
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] - sub[e]);
        l[e] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) acc_to_a(sc, kk, pa[kk]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], desc_mn<D>(sv, kBN, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && j + S < tiles) {
      mbar_wait(&empty[s], (j / S) & 1);  // both warpgroups are done with it
      load_kv(j + S);
    }
    __syncwarp();
  }

  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    inv[e] = l[e] > 0.f ? 1.f / l[e] : 0.f;
  }
  // O through this warpgroup's own rows of the Q tile (its last wgmma that
  // read them has completed), then one TMA store per panel
  acc_to_tile<D>(smem + L::q, kBM, 64 * wg, o, inv[0], inv[1]);
  fence_async_smem();
  warpgroup_sync(1 + wg);
  if (t == 0 && row0 < n) {
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
      tma_store(&maps.o, smem + L::q + p * T::panel(kBM) + 64 * wg * T::kSwz,
                p * T::kPW, row0, h, b);
    tma_store_wait();
  }
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + r + 8 * e;
      // a row with no valid key gets +inf, so exp(s - lse) = 0 backward
      if (row < n)
        lse[static_cast<long long>(bh) * n + row] =
            l[e] > 0.f ? m[e] * kLn2 + logf(l[e]) : INFINITY;
    }
  }
}

// D: the tile's head dim; hd <= D: the logical one, the maps' extent
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int n, int hd, int kv_valid, int causal, float scale,
           long long sb, long long sh, long long sn, long long ob,
           long long oh, long long on, cudaStream_t stream) {
  using T = Tile<D>;
  const int bytes = static_cast<int>(FwdSmem<D>::bytes);
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int kv_lim = std::max(0, std::min(n, kv_valid));
  const int kvr = std::max(kv_lim, 1);
  const int w = T::kPW, sw = T::kSwz;
  FwdMaps maps;
  // hd columns: TMA zero-fills the tile's columns past them and drops
  // them from the store
  int err = make_map(&maps.q, q, hd, n, H, B, sn, sh, sb, w, kBM, sw);
  // K/V end at kv_lim: TMA zero-fills the keys past it
  if (!err) err = make_map(&maps.k, k, hd, kvr, H, B, sn, sh, sb, w, kBN, sw);
  if (!err) err = make_map(&maps.v, v, hd, kvr, H, B, sn, sh, sb, w, kBN, sw);
  if (!err) err = make_map(&maps.o, o, hd, n, H, B, on, oh, ob, w, 64, sw);
  if (err) return err;
  const int q_tiles = (n + kBM - 1) / kBM;
  // b*h and the Q tile folded into x: no 65535 limit, and the blocks that
  // share one head's K/V run side by side
  attention_kernel<D><<<B * H * q_tiles, 256, bytes, stream>>>(
      maps, static_cast<float*>(lse), H, n, kv_lim, causal, scale * kLog2e,
      q_tiles, (hd + 15) / 16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cet

// D: the logical head dim, a multiple of 8 up to 128 (else
// cudaErrorInvalidValue); run on the smallest tile of 32, 64 or 128 that
// holds it
extern "C" int cet_attention(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int n, int D,
                             int kv_valid, int causal, float scale, long long sb,
                             long long sh, long long sn, long long ob,
                             long long oh, long long on, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 8 || D > 128 || D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32)
    return cet::launch<32>(q, k, v, o, lse, B, H, n, D, kv_valid, causal,
                           scale, sb, sh, sn, ob, oh, on, s);
  if (D <= 64)
    return cet::launch<64>(q, k, v, o, lse, B, H, n, D, kv_valid, causal,
                           scale, sb, sh, sn, ob, oh, on, s);
  return cet::launch<128>(q, k, v, o, lse, B, H, n, D, kv_valid, causal,
                          scale, sb, sh, sn, ob, oh, on, s);
}
