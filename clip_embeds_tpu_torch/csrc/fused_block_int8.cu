// W8A8 pre-LN transformer block: int8 tensor-core GEMMs with dequantising
// epilogues, and LayerNorm / elementwise passes with quantising stores.
//
// Replaces the Pallas kernel clip_embeds_tpu/ops/fused_block.py
// `fused_block_int8` (`_kernel_int8`, `_qdot`), which keeps a whole block's
// int8 weights (12.6 MB at ViT-L) resident in TPU VMEM. One SM has 227 KB of
// shared memory, so on Hopper the block is a chain of launches that keeps the
// Pallas kernel's rounding points (ops/fused_block.py drives it):
//
//   hq   = q8(bf16(LN1(x)), a0)                  layernorm_s8_kernel
//   qkv  = bf16(acc(hq, Wqkv) * (a0 s) + b)      gemm_s8_kernel, EPI_BF16
//   att  = attention(qkv)                        attention.cu (bf16)
//   attq = q8(att, a1)                           quantize_s8_kernel
//   x'   = x + bf16(acc(attq, Wo) * (a1 s) + b)  gemm_s8_kernel, EPI_RESIDUAL
//   hq   = q8(bf16(LN2(x')), a2)                 layernorm_s8_kernel
//   mq   = q8(act(acc(hq, W1) * (a2 s) + b), a3) gemm_s8_kernel, EPI_ACT_Q8
//   y    = x' + bf16(acc(mq, W2) * (a3 s) + b)   gemm_s8_kernel, EPI_RESIDUAL
//
// q8(v, a) = clip(rint(v / a), -127, 127): a true fp32 division and
// round-half-even, as jnp.round(x / a) (a multiply by 1/a moves codes near
// the .5 boundaries). The MLP activation is quantised straight from fp32,
// not rounded to bf16 first (`_kernel_int8`, unlike the bf16 block). The
// dequantisation is (float(acc) * (a * s)) + b with no fused multiply-add,
// the plain version's order. `a` is the block's four static activation
// scales (qkv, out, fc, proj), read from device memory: no host sync.
//
// Bound: the four projections are 24 * n * d^2 int8 ops per sequence, far
// above the H100's ridge (1,979 TOPS int8 dense, twice the bf16 rate, on
// 3.35 TB/s), so the GEMM is compute-bound; the LN and quantise passes are
// bandwidth-bound (one bf16 read, one int8 write).
// Design: int8 weights stay in the [out, in] layout, K-major, which is the
// col-major B operand of mma.sync.m16n8k32.s8.s8.s32, so no per-call
// transpose. 128x128x64 block tiles, eight warps of 64x32, a three-stage
// cp.async pipeline (16 int8 values per 16-byte copy), ldmatrix from padded
// (80-byte) shared rows, int32 accumulators, and an epilogue that
// dequantises, adds the bias (and the residual, or the activation and the
// next quantisation) before the one store. wgmma/TMA come in a later change.

#include "common.cuh"

namespace cet {
namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;  // kBK in int8 values (bytes)
constexpr int kLd = kBK + 16;                   // padded smem row: 80 bytes
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kLd;
constexpr int kSmemBytes = kStages * kStageBytes;  // 61,440: dynamic smem

enum Epilogue { EPI_BF16 = 0, EPI_ACT_Q8 = 1, EPI_RESIDUAL = 2 };

__device__ __forceinline__ int8_t quantize(float v, float a) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, a)), -127.f), 127.f);
  return static_cast<int8_t>(q);
}

__device__ __forceinline__ float dequantize(int acc, float scale, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(acc), scale), b);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += A(16x32, row) . B(32x8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y[m, :] = q8(bf16(LN(x[m, :]) * gamma + beta), act_scales[a_idx]): one
// warp per row. The Pallas kernel's LN returns the activation dtype, so the
// value is rounded to bf16 before it is quantised.
__global__ void __launch_bounds__(256)
layernorm_s8_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                    const bf16* __restrict__ beta,
                    const float* __restrict__ act_scales, int a_idx,
                    int8_t* __restrict__ y, int rows, int d, float eps) {
  int row = blockIdx.x * 8 + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * d;
  float mu, rstd;
  row_ln_stats(xr, d, lane, eps, mu, rstd);
  const float a = act_scales[a_idx];
  int8_t* yr = y + static_cast<size_t>(row) * d;
  for (int c = lane; c < d; c += 32) {
    const float h = bf2f(
        f2bf((bf2f(xr[c]) - mu) * rstd * bf2f(gamma[c]) + bf2f(beta[c])));
    yr[c] = quantize(h, a);
  }
}

__global__ void __launch_bounds__(256)
quantize_s8_kernel(const bf16* __restrict__ x,
                   const float* __restrict__ act_scales, int a_idx,
                   int8_t* __restrict__ y, long long n) {
  const float a = act_scales[a_idx];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step)
    y[i] = quantize(bf2f(x[i]), a);
}

// C[M, N] = epilogue(A[M, K] W[N, K]^T), A and W int8, int32 accumulation.
// Requires K % 16 == 0 (16-byte rows) and N % 16 == 0 (checked by the
// wrapper); ragged M, N and K tile edges are zero-filled on load (zeros add
// nothing to the sum) and M, N edges are masked on store.
__global__ void __launch_bounds__(kThreads)
gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
               const float* __restrict__ wscale, const float* __restrict__ bias,
               const float* __restrict__ act_scales, int a_idx,
               const bf16* __restrict__ res, void* __restrict__ C, int M,
               int N, int K, int epi, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4;  // 2 warps along M, 64 rows each
  const int wn = warp % 4;  // 4 warps along N, 32 cols each
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  constexpr int kChunks = kBK / 16;  // 16-byte chunks per tile row

  auto load_tile = [&](int stage, int k0) {
    unsigned char* As = smem + stage * kStageBytes;
    unsigned char* Ws = As + kBM * kLd;
    for (int c = tid; c < kBM * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = (c % kChunks) * 16;
      const int gr = m0 + r, gk = k0 + cc;
      const bool ok = gr < M && gk < K;
      cp_async16(As + r * kLd + cc,
                 A + (ok ? static_cast<size_t>(gr) * K + gk : 0), ok);
    }
    for (int c = tid; c < kBN * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = (c % kChunks) * 16;
      const int gn = n0 + r, gk = k0 + cc;
      const bool ok = gn < N && gk < K;
      cp_async16(Ws + r * kLd + cc,
                 W + (ok ? static_cast<size_t>(gn) * K + gk : 0), ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();  // ... every thread's part, and stage kt-1 is free
    const int pre = kt + kStages - 1;
    if (pre < nk) load_tile(pre % kStages, pre * kBK);
    cp_async_commit();

    const unsigned char* As = smem + (kt % kStages) * kStageBytes;
    const unsigned char* Ws = As + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // A fragments: matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7,
      // 16-31), (8-15, 16-31) are mma's a0..a3.
      unsigned af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af[i], As + r * kLd + kk + (lane >> 4) * 16);
      }
      // B fragments of two n8 tiles: matrices (n 0-7, k 0-15), (n 0-7,
      // k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31).
      unsigned bfr[4][2];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int r = wn * 32 + j * 8 + (lane & 7) + (lane >> 4) * 8;
        unsigned t[4];
        ldmatrix_x4(t, Ws + r * kLd + kk + ((lane >> 3) & 1) * 16);
        bfr[j][0] = t[0];
        bfr[j][1] = t[1];
        bfr[j + 1][0] = t[2];
        bfr[j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue straight from registers: accumulator e of tile (i, j) sits at
  // row g (+8 for e >= 2), columns 2 * t4 + (e & 1).
  const int g = lane >> 2, t4 = lane & 3;
  const float a = act_scales[a_idx];
  const float a_next = epi == EPI_ACT_Q8 ? act_scales[a_idx + 1] : 1.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + t4 * 2;
    if (col >= N) continue;  // N % 16 == 0, so col + 1 < N as well
    const float sc0 = __fmul_rn(a, wscale[col]);
    const float sc1 = __fmul_rn(a, wscale[col + 1]);
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + i * 16 + g + h * 8;
        if (row >= M) continue;
        const size_t off = static_cast<size_t>(row) * N + col;
        float v0 = dequantize(acc[i][j][2 * h], sc0, b0);
        float v1 = dequantize(acc[i][j][2 * h + 1], sc1, b1);
        if (epi == EPI_ACT_Q8) {
          char2 q;
          q.x = quantize(apply_act(v0, act), a_next);
          q.y = quantize(apply_act(v1, act), a_next);
          *reinterpret_cast<char2*>(static_cast<int8_t*>(C) + off) = q;
          continue;
        }
        if (epi == EPI_RESIDUAL) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(res + off);
          v0 = bf2f(r.x) + bf2f(f2bf(v0));
          v1 = bf2f(r.y) + bf2f(f2bf(v1));
        }
        __nv_bfloat162 o;
        o.x = f2bf(v0);
        o.y = f2bf(v1);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + off) = o;
      }
    }
  }
}

}  // namespace
}  // namespace cet

extern "C" {

int cet_layernorm_s8(const void* x, const void* gamma, const void* beta,
                     const void* act_scales, int a_idx, void* y, int rows,
                     int d, float eps, void* stream) {
  using cet::bf16;
  dim3 grid((rows + 7) / 8);
  cet::layernorm_s8_kernel<<<grid, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<const float*>(act_scales),
      a_idx, static_cast<int8_t*>(y), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

int cet_quantize_s8(const void* x, const void* act_scales, int a_idx, void* y,
                    long long n, void* stream) {
  using cet::bf16;
  const long long blocks = (n + 255) / 256;
  dim3 grid(static_cast<unsigned>(blocks < 8192 ? (blocks > 0 ? blocks : 1)
                                                : 8192));
  cet::quantize_s8_kernel<<<grid, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(act_scales),
      a_idx, static_cast<int8_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

int cet_gemm_s8(const void* a, const void* w, const void* wscale,
                const void* bias, const void* act_scales, int a_idx,
                const void* res, void* c, int m, int n, int k, int epi,
                int act, void* stream) {
  using cet::bf16;
  cudaError_t err = cudaFuncSetAttribute(
      cet::gemm_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cet::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // row tiles on x (no 65535 limit), column tiles on y
  dim3 grid((m + cet::kBM - 1) / cet::kBM, (n + cet::kBN - 1) / cet::kBN);
  cet::gemm_s8_kernel<<<grid, cet::kThreads, cet::kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<const float*>(act_scales), a_idx,
      static_cast<const bf16*>(res), c, m, n, k, epi, act);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
