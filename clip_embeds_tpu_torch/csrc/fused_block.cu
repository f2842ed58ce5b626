// LayerNorm and GEMM-with-epilogue kernels: the non-attention half of the
// fused pre-LN transformer block.
//
// Replaces the Pallas kernel clip_embeds_tpu/ops/fused_block.py `fused_block`
// (`_kernel`), which keeps a whole block's weights resident in TPU VMEM and
// runs LN1 -> qkv -> attention -> out-proj -> LN2 -> MLP per sequence. At
// ViT-L width that is ~25 MB of bf16 weights, far beyond one SM's 227 KB of
// shared memory, so on Hopper the block is a short chain of launches
// (ops/fused_block.py drives it):
//
//   h   = LN1(x)                          layernorm_kernel
//   qkv = bf16(h Wqkv^T + bqkv)           gemm_kernel, EPI_BIAS
//   att = attention(qkv)                  attention.cu
//   x'  = x + bf16(att Wo^T + bo)         gemm_kernel, EPI_BIAS_RESIDUAL
//   h   = LN2(x')                         layernorm_kernel
//   m   = bf16(act(h W1^T + b1))          gemm_kernel, EPI_BIAS_ACT
//   y   = x' + bf16(m W2^T + b2)          gemm_kernel, EPI_BIAS_RESIDUAL
//
// fused_block_residuals (the Pallas `fused_block_residuals`, `_kernel_res`)
// is the same chain, which keeps qkv, the attention output and x' in device
// memory anyway; on c_fc it takes EPI_BIAS_ACT_PRE, which stores both the
// pre-activation m1 = bf16(h W1^T + b1) and bf16(act(h W1^T + b1)), the
// activation taken from the fp32 sum as in `_kernel_res`.
//
// The rounding points are the Pallas kernel's, so bf16 results compare
// tightly with the plain PyTorch version.
//
// Bound: the four projections are 24 * n * d^2 FLOPs per sequence and run
// well above the H100's ~295 FLOP/byte bf16 ridge, so the GEMM is
// compute-bound; LayerNorm is bandwidth-bound (one read, one write).
// Design: weights stay in the open_clip [out, in] layout, which is K-major,
// the natural col-major B operand of a bf16 tensor-core MMA, so no per-call
// transpose. 128x128x32 block tiles, eight warps of 64x32, WMMA bf16 with
// fp32 accumulation, a two-stage cp.async pipeline, and an epilogue that
// adds the bias (and the activation or the residual) before the single
// bf16 store. wgmma/TMA come in a later change.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace cet {
namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLds = kBK + 8;  // padded smem row (80 bytes), fewer conflicts
constexpr int kThreads = 256;

enum Epilogue {
  EPI_BIAS = 0,
  EPI_BIAS_ACT = 1,
  EPI_BIAS_RESIDUAL = 2,
  EPI_BIAS_ACT_PRE = 3,  // EPI_BIAS_ACT, and bf16(sum + bias) into `pre`
};

// y[m, :] = bf16(LN(x[m, :]) * gamma + beta): one warp per row, fp32 stats.
__global__ void __launch_bounds__(256)
layernorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                 const bf16* __restrict__ beta, bf16* __restrict__ y, int rows,
                 int d, float eps) {
  int row = blockIdx.x * 8 + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * d;
  float mu, rstd;
  row_ln_stats(xr, d, lane, eps, mu, rstd);
  bf16* yr = y + static_cast<size_t>(row) * d;
  for (int c = lane; c < d; c += 32)
    yr[c] = f2bf((bf2f(xr[c]) - mu) * rstd * bf2f(gamma[c]) + bf2f(beta[c]));
}

// C[M, N] = epilogue(A[M, K] W[N, K]^T + bias[N]); `pre` [M, N] is written
// only by the kPre instance, which EPI_BIAS_ACT_PRE launches (so the serving
// epilogues compile as they did without it).
// Requires K % 32 == 0 and N % 8 == 0 (checked by the wrapper); ragged M and
// N tile edges are zero-filled on load and masked on store.
template <bool kPre>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, const bf16* __restrict__ res,
            bf16* __restrict__ C, bf16* __restrict__ pre, int M, int N, int K,
            int epi, int act) {
  __shared__ __align__(128) bf16 smem[2 * (kBM + kBN) * kLds];
  bf16* As[2] = {smem, smem + kBM * kLds};
  bf16* Ws[2] = {smem + 2 * kBM * kLds, smem + 2 * kBM * kLds + kBN * kLds};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4;  // 2 warps along M, 64 rows each
  const int wn = warp % 4;  // 4 warps along N, 32 cols each
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  constexpr int kChunks = kBK / 8;  // 16-byte chunks per tile row

  auto load_tile = [&](int stage, int k0) {
    for (int c = tid; c < kBM * kChunks; c += kThreads) {
      int r = c / kChunks, cc = (c % kChunks) * 8;
      int gr = m0 + r;
      bool ok = gr < M;
      cp_async16(&As[stage][r * kLds + cc],
                 A + static_cast<size_t>(ok ? gr : 0) * K + k0 + cc, ok);
    }
    for (int c = tid; c < kBN * kChunks; c += kThreads) {
      int r = c / kChunks, cc = (c % kChunks) * 8;
      int gn = n0 + r;
      bool ok = gn < N;
      cp_async16(&Ws[stage][r * kLds + cc],
                 W + static_cast<size_t>(ok ? gn : 0) * K + k0 + cc, ok);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = K / kBK;
  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile(cur ^ 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &As[cur][(wm * 64 + i * 16) * kLds + kk],
                               kLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], &Ws[cur][(wn * 32 + j * 16) * kLds + kk],
                               kLds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration refills the buffer just read
  }

  // Epilogue: each warp stages one 16x16 fp32 fragment at a time in the
  // (now free) pipeline smem; each lane finishes 8 consecutive columns.
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + r;
      const int gc = n0 + wn * 32 + j * 16 + c;
      if (gr < M && gc < N) {
        const size_t off = static_cast<size_t>(gr) * N + gc;
        __align__(16) bf16 out[8];
        __align__(16) bf16 rv[8];
        __align__(16) bf16 pv[8];  // unused (compiled out) unless kPre
        if (epi == EPI_BIAS_RESIDUAL)
          *reinterpret_cast<uint4*>(rv) =
              *reinterpret_cast<const uint4*>(res + off);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = stage[r * 16 + c + e] + bf2f(bias[gc + e]);
          if (kPre) pv[e] = f2bf(v);
          if (kPre || epi == EPI_BIAS_ACT) v = apply_act(v, act);
          if (epi == EPI_BIAS_RESIDUAL) v = bf2f(rv[e]) + bf2f(f2bf(v));
          out[e] = f2bf(v);
        }
        *reinterpret_cast<uint4*>(C + off) = *reinterpret_cast<uint4*>(out);
        if (kPre)
          *reinterpret_cast<uint4*>(pre + off) = *reinterpret_cast<uint4*>(pv);
      }
      __syncwarp();
    }
  }
}

}  // namespace
}  // namespace cet

extern "C" {

int cet_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                  int rows, int d, float eps, void* stream) {
  using cet::bf16;
  dim3 grid((rows + 7) / 8);
  cet::layernorm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

int cet_gemm(const void* a, const void* w, const void* bias, const void* res,
             void* c, void* pre, int m, int n, int k, int epi, int act,
             void* stream) {
  using cet::bf16;
  // row tiles on x (no 65535 limit), column tiles on y
  dim3 grid((m + cet::kBM - 1) / cet::kBM, (n + cet::kBN - 1) / cet::kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *A = static_cast<const bf16*>(a), *W = static_cast<const bf16*>(w);
  const bf16 *B = static_cast<const bf16*>(bias);
  const bf16* R = static_cast<const bf16*>(res);
  bf16 *C = static_cast<bf16*>(c), *P = static_cast<bf16*>(pre);
  if (epi == cet::EPI_BIAS_ACT_PRE)
    cet::gemm_kernel<true><<<grid, cet::kThreads, 0, s>>>(A, W, B, R, C, P, m,
                                                          n, k, epi, act);
  else
    cet::gemm_kernel<false><<<grid, cet::kThreads, 0, s>>>(A, W, B, R, C, P,
                                                           m, n, k, epi, act);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
