// Exact softmax attention backward, bf16 in and out: dQ, dK, dV.
//
// Replaces the Pallas kernel clip_embeds_tpu/ops/flash_attention.py
// `_attn_bwd_kernel` (wired in by `_flash_attention_bwd_impl` and the
// custom VJP's `_bwd`). Per (b*h, Q tile) the TPU kernel recomputes P from
// (q, k), and accumulates dK and dV across Q tiles in output blocks that
// the sequential TPU grid revisits. Blocks of a Hopper grid run in parallel
// and in no order, so here the work is three launches with no atomics,
// which also makes the result deterministic:
//
//   (a) delta = rowsum(dO * O)                 fp32 [B*H, N], one warp a row
//   (b) dK, dV: one block per (b*h, 64-key tile), looping over the Q tiles
//       that see those keys:  S^T = K Q^T,  P^T = exp(S^T * scale - lse),
//       dV += P^T(bf16) dO,  dP^T = V dO^T,  dS^T = P^T (dP^T - delta) scale,
//       dK += dS^T(bf16) Q
//   (c) dQ: one block per (b*h, 64-row Q tile), looping over the key tiles:
//       the same S, P, dP and dS,  dQ += dS(bf16) K
//
// P is the normalised fp32 probability exp(s - lse), with lse the forward's
// log-sum-exp (attention.cu writes it); P and dS are rounded to bf16 before
// their products, as the Pallas kernel rounds them to the input dtype, and
// every product accumulates in fp32 WMMA fragments held in registers, cast
// to bf16 once at the end. Masked (q, k) pairs (key >= kv_valid, key > query
// when causal, padded rows) get P = 0. Q, K, V, O and dO are read through
// their strides, so views of the packed [B, n, 3d] qkv buffer cost no copy.
//
// Bound: 10 * N^2 * D FLOPs per head (the Pallas cost estimate: 2 N^2 D
// for each of S, dP, dV, dK and dQ) against 8 * N * D * 2 bytes of IO; at
// ViT-L (N = 577, D = 64) that is far above the bf16 ridge, so the kernel is
// compute- and latency-bound. S and dP are computed in both (b) and (c)
// (14 N^2 D FLOPs done for the 10 counted) in exchange for no atomics and no
// cross-block reduction; wgmma and a fused (b)+(c) come in a later change.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace cet {
namespace {

constexpr int kBT = 64;        // rows of a Q tile and of a K/V tile
constexpr int kBwdWarps = 4;   // each warp owns 16 rows of the block's tile
constexpr int kLdF = kBT + 4;  // fp32 [16 x 64] scratch row
constexpr int kLdH = kBT + 8;  // bf16 [16 x 64] scratch row

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBt;

template <int D>
struct BwdSmem {
  static constexpr int kLdB = D + 8;  // bf16 [64 x D] tile row
  static constexpr size_t tile = sizeof(bf16) * kBT * kLdB;
  static constexpr size_t t0 = 0, t1 = tile, t2 = 2 * tile, t3 = 3 * tile;
  static constexpr size_t lse = 4 * tile;                       // fp32 [64]
  static constexpr size_t delta = lse + sizeof(float) * kBT;    // fp32 [64]
  static constexpr size_t s = delta + sizeof(float) * kBT;      // per warp
  static constexpr size_t dp = s + sizeof(float) * kBwdWarps * 16 * kLdF;
  static constexpr size_t p = dp + sizeof(float) * kBwdWarps * 16 * kLdF;
  static constexpr size_t bytes = p + sizeof(bf16) * kBwdWarps * 16 * kLdH;
};

// Copy rows [r0, r0 + 64) of a [n, D] head slice (row stride `sr`) into a
// padded shared tile; rows at or past `lim` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long sr, int r0, int lim) {
  constexpr int kChunks = D / 8, kLdB = D + 8;
  for (int c = threadIdx.x; c < kBT * kChunks; c += kBwdWarps * 32) {
    const int r = c / kChunks, cc = (c % kChunks) * 8;
    const int gr = r0 + r;
    const bool ok = gr < lim;
    cp_async16(&dst[r * kLdB + cc], src + (ok ? gr : 0) * sr + cc, ok);
  }
}

// out[16 x 64] (fp32, ld kLdF) = A_rows[16 x D] B_rows[64 x D]^T, where A
// is this warp's 16 rows of one tile and B the 64 rows of another.
template <int D>
__device__ __forceinline__ void rows_times_rows_t(float* out, const bf16* a,
                                                  const bf16* b) {
  constexpr int kLdB = D + 8;
#pragma unroll
  for (int j = 0; j < kBT / 16; ++j) {
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + kk * 16, kLdB);
      wmma::load_matrix_sync(fb, b + (j * 16) * kLdB + kk * 16, kLdB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, kLdF, wmma::mem_row_major);
  }
}

// acc[D / 16] += P[16 x 64] (bf16, ld kLdH) T[64 x D] (a shared tile).
template <int D>
__device__ __forceinline__ void accumulate(Acc* acc, const bf16* p,
                                           const bf16* t) {
  constexpr int kLdB = D + 8;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, p + kk * 16, kLdH);
      wmma::load_matrix_sync(fb, t + (kk * 16) * kLdB + j * 16, kLdB);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// Store a warp's [16 x D] fp32 accumulators as bf16 rows of `out` (row
// stride `so`), staged one 16x16 fragment at a time through `stage`; rows
// whose global index is >= n are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long so,
                                           const Acc* acc, float* stage,
                                           int row0, int n) {
  const int lane = threadIdx.x % 32, r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(stage, acc[j], kLdF, wmma::mem_row_major);
    __syncwarp();
    if (row0 + r < n) {
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = f2bf(stage[r * kLdF + c + e]);
      *reinterpret_cast<uint4*>(out + (row0 + r) * so + j * 16 + c) =
          *reinterpret_cast<uint4*>(vals);
    }
    __syncwarp();
  }
}

// (a) delta[row] = sum_d dO[row, d] * O[row, d], one warp per row; batch b
// on grid y, the H * n rows of one batch on x.
__global__ void __launch_bounds__(256)
attention_bwd_delta_kernel(const bf16* __restrict__ o,
                           const bf16* __restrict__ g,
                           float* __restrict__ delta, int H, int n, int D,
                           long long ob, long long oh, long long on,
                           long long gb, long long gh, long long gn) {
  const int hi = blockIdx.x * 8 + threadIdx.x / 32;  // h * n + i
  const int lane = threadIdx.x % 32, b = blockIdx.y;
  if (hi >= H * n) return;
  const int h = hi / n, i = hi % n;
  const bf16* orow = o + b * ob + h * oh + i * on;
  const bf16* grow = g + b * gb + h * gh + i * gn;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += bf2f(orow[c]) * bf2f(grow[c]);
  s = warp_sum(s);
  if (lane == 0) delta[(static_cast<long long>(b) * H) * n + hi] = s;
}

struct BwdArgs {
  const bf16 *q, *k, *v, *g;      // g = dO
  const float *lse, *delta;       // fp32 [B*H, n]
  bf16 *dq, *dk, *dv;
  int H, n, kv_valid, causal;
  float scale;
  long long sb, sh, sn;           // q, k, v strides
  long long gb, gh, gn;           // dO strides
  long long xb, xh, xn;           // dq, dk, dv strides
};

// (b) dK and dV of one (b*h, 64-key tile).
template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_bwd_dkdv_kernel(BwdArgs a) {
  using L = BwdSmem<D>;
  constexpr int kLdB = L::kLdB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::t0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::t1);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::t2);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L::t3);
  float* Ls = reinterpret_cast<float*>(smem + L::lse);
  float* Ds = reinterpret_cast<float*>(smem + L::delta);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* Sw = reinterpret_cast<float*>(smem + L::s) + warp * 16 * kLdF;
  float* DPw = reinterpret_cast<float*>(smem + L::dp) + warp * 16 * kLdF;
  bf16* Pw = reinterpret_cast<bf16*>(smem + L::p) + warp * 16 * kLdH;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kBT, n = a.n;
  const long long base = b * a.sb + h * a.sh;
  const bf16* qb = a.q + base;
  const bf16* gb = a.g + b * a.gb + h * a.gh;
  const float* lse = a.lse + static_cast<long long>(bh) * n;
  const float* delta = a.delta + static_cast<long long>(bh) * n;
  const int kv_lim = min(n, a.kv_valid);

  load_tile<D>(Ks, a.k + base, a.sn, k0, kv_lim);
  load_tile<D>(Vs, a.v + base, a.sn, k0, kv_lim);
  cp_async_commit();

  Acc dk[D / 16], dv[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }

  // the softmax element (key row r of this warp, query column) of a lane
  const int r = lane / 2, half = lane % 2;
  const int key = k0 + warp * 16 + r;
  // causal: the Q tiles before k0 see none of these keys
  const int q_begin = a.causal ? k0 : 0;
  for (int q0 = q_begin; k0 < kv_lim && q0 < n; q0 += kBT) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D>(Qs, qb, a.sn, q0, n);
    load_tile<D>(Gs, gb, a.gn, q0, n);
    cp_async_commit();
    for (int i = tid; i < kBT; i += kBwdWarps * 32) {
      const int gr = q0 + i;
      Ls[i] = gr < n ? lse[gr] : INFINITY;
      Ds[i] = gr < n ? delta[gr] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    rows_times_rows_t<D>(Sw, Ks + warp * 16 * kLdB, Qs);   // S^T
    rows_times_rows_t<D>(DPw, Vs + warp * 16 * kLdB, Gs);  // dP^T
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c, qr = q0 + col;
      const bool ok = key < kv_lim && qr < n && (!a.causal || key <= qr);
      const float p = ok ? expf(Sw[r * kLdF + col] * a.scale - Ls[col]) : 0.f;
      Pw[r * kLdH + col] = f2bf(p);
      Sw[r * kLdF + col] = p * (DPw[r * kLdF + col] - Ds[col]) * a.scale;
    }
    __syncwarp();
    accumulate<D>(dv, Pw, Gs);  // dV += P^T dO
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      Pw[r * kLdH + col] = f2bf(Sw[r * kLdF + col]);
    }
    __syncwarp();
    accumulate<D>(dk, Pw, Qs);  // dK += dS^T Q
  }
  cp_async_wait<0>();  // a block with no Q tile still drains its K/V copy

  const int row0 = k0 + warp * 16;
  store_rows<D>(a.dk + b * a.xb + h * a.xh, a.xn, dk, Sw, row0, n);
  store_rows<D>(a.dv + b * a.xb + h * a.xh, a.xn, dv, Sw, row0, n);
}

// (c) dQ of one (b*h, 64-row Q tile).
template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_bwd_dq_kernel(BwdArgs a) {
  using L = BwdSmem<D>;
  constexpr int kLdB = L::kLdB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::t0);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L::t1);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::t2);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::t3);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* Sw = reinterpret_cast<float*>(smem + L::s) + warp * 16 * kLdF;
  float* DPw = reinterpret_cast<float*>(smem + L::dp) + warp * 16 * kLdF;
  bf16* Pw = reinterpret_cast<bf16*>(smem + L::p) + warp * 16 * kLdH;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kBT, n = a.n;
  const long long base = b * a.sb + h * a.sh;
  load_tile<D>(Qs, a.q + base, a.sn, q0, n);
  load_tile<D>(Gs, a.g + b * a.gb + h * a.gh, a.gn, q0, n);
  cp_async_commit();

  const int r = lane / 2, half = lane % 2;
  const int qrow = q0 + warp * 16 + r;
  const long long row = static_cast<long long>(bh) * n + qrow;
  const float lse_r = qrow < n ? a.lse[row] : INFINITY;
  const float delta_r = qrow < n ? a.delta[row] : 0.f;

  Acc dq[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq[j], 0.f);

  const int kv_lim = min(n, a.kv_valid);
  const int kv_end = a.causal ? min(kv_lim, q0 + kBT) : kv_lim;
  for (int k0 = 0; k0 < kv_end; k0 += kBT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, a.k + base, a.sn, k0, kv_end);
    load_tile<D>(Vs, a.v + base, a.sn, k0, kv_end);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    rows_times_rows_t<D>(Sw, Qs + warp * 16 * kLdB, Ks);   // S
    rows_times_rows_t<D>(DPw, Gs + warp * 16 * kLdB, Vs);  // dP
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c, kc = k0 + col;
      const bool ok = kc < kv_lim && qrow < n && (!a.causal || kc <= qrow);
      const float p = ok ? expf(Sw[r * kLdF + col] * a.scale - lse_r) : 0.f;
      Pw[r * kLdH + col] =
          f2bf(p * (DPw[r * kLdF + col] - delta_r) * a.scale);
    }
    __syncwarp();
    accumulate<D>(dq, Pw, Ks);  // dQ += dS K
  }
  cp_async_wait<0>();  // a block with no key tile still drains its Q copy

  store_rows<D>(a.dq + b * a.xb + h * a.xh, a.xn, dq, Sw, q0 + warp * 16, n);
}

template <int D>
int launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  const int bytes = static_cast<int>(BwdSmem<D>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dkdv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * a.H, (a.n + kBT - 1) / kBT);  // b*h on x: no 65535 limit
  attention_bwd_dkdv_kernel<D><<<grid, kBwdWarps * 32, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<D><<<grid, kBwdWarps * 32, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cet

// q, k, v: [B, H, n, D] through strides (sb, sh, sn); o, dO through
// (ob, oh, on) and (gb, gh, gn); lse: the forward's fp32 [B*H, n]; delta:
// fp32 [B*H, n] scratch; dq, dk, dv: bf16 outputs through (xb, xh, xn).
extern "C" int cet_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int n, int D, int kv_valid, int causal,
    float scale, long long sb, long long sh, long long sn, long long ob,
    long long oh, long long on, long long gb, long long gh, long long gn,
    long long xb, long long xh, long long xn, void* stream) {
  using cet::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid_delta((H * n + 7) / 8, B);
  cet::attention_bwd_delta_kernel<<<grid_delta, 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), H, n, D, ob, oh, on, gb, gh, gn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cet::BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                 static_cast<const float*>(lse),
                 static_cast<const float*>(delta), static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, n,
                 kv_valid, causal, scale, sb, sh, sn, gb, gh, gn, xb, xh,
                 xn};
  switch (D) {
    case 32:
      return cet::launch_bwd<32>(a, B, s);
    case 64:
      return cet::launch_bwd<64>(a, B, s);
    case 128:
      return cet::launch_bwd<128>(a, B, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
