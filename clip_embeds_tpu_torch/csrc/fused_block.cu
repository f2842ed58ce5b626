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
// compute-bound (the out-projection with its residual read comes close to
// the line at d = 1024); LayerNorm is bandwidth-bound (one read, one write).
// Design of the GEMM, C[M, N] = epilogue(A[M, K] W[N, K]^T + bias[N]): A
// (activation rows) and W (the open_clip [out, in] weight) are both
// K-major, so each arrives by TMA as 64-column tiles with a 128-byte
// swizzle and feeds wgmma straight from shared memory, with no transpose.
// Output tiles are 128 x BN (BN = 128, or 64 where tiles of 128 would leave
// most SMs idle; the launcher picks by shape), K in stages of 64:
// - warpgroup 2 produces: one thread keeps a ring of (A, W) tile pairs in
//   flight on full/empty mbarriers, tile after tile, and the warpgroup
//   hands most of its registers to the consumers (setmaxnreg: without it
//   ptxas spills in the 128-wide instances);
// - warpgroups 0 and 1 take the block's tiles in turn (ping-pong): while
//   one runs its products, the other runs its epilogue, so the tensor
//   cores do not wait on bias, activation and stores. A turn barrier
//   passes the products from one to the other. A tile's products are
//   eight m64nBNk16 wgmmas a stage (two 64-row halves), then
//   wgmma_wait<1>, so one stage's products run while the next stage's are
//   issued; a stage goes back to the producer once the wait retires it;
// - the epilogue works on the fp32 accumulators in registers (bias, then
//   the activation, the pre-activation store or the residual, at the
//   rounding points above) and writes bf16 into four 64 x 64 staging
//   pieces of the warpgroup in TMA's swizzled layout, which TMA stores;
//   the residual's pieces come into the same buffers by TMA while the
//   products run, and the sums replace them;
// - the grid is persistent, one block per SM walking the output tiles
//   with N fastest (consecutive tiles reuse A's rows from L2).
// TMA zero-fills rows past M and N and columns past K and drops stores
// past them. No split-K and no atomics: two calls are bit-equal.

#include "hopper.cuh"

namespace cet {
namespace {

constexpr int kBM = 128, kBK = 64;  // rows of an output tile, K of a stage
constexpr int kThreads = 384;       // two consumer warpgroups, one producer

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

struct GemmMaps {
  CUtensorMap a, w, c, res, pre;  // res and pre only where given
};

// Shared memory of a block: the ring (160 KB: 5 or 6 stages of a 128-row
// A tile and a BN-row W tile, 64 columns each), four 8 KB staging pieces
// (64 x 64 bf16, the TMA's swizzled layout) and BN bias values per
// consumer warpgroup, the barriers.
template <int BN>
struct GemmSmem {
  using T = Tile<kBK>;
  static constexpr uint32_t kA = T::bytes(kBM);
  static constexpr uint32_t kW = T::bytes(BN);
  static constexpr int kStages = 163840 / (kA + kW);
  static constexpr uint32_t kPiece = T::bytes(64);
  static constexpr uint32_t a = 0;
  static constexpr uint32_t w = a + kStages * kA;
  static constexpr uint32_t out = w + kStages * kW;
  static constexpr uint32_t bias = out + 8 * kPiece;
  static constexpr uint32_t bar = bias + 2 * BN * 2;  // full, empty, turn, res
  static constexpr uint32_t bytes = bar + (2 * kStages + 4) * 8 + 1024;
};

// The activation in fp32, one instance per kind so that an epilogue holds
// only its own. Quick GELU takes the fast exp and divide: a relative error
// near 1e-6, far under the 2^-9 of the bf16 rounding that follows; erf and
// tanh GELU are common.cuh's.
template <int kAct>
__device__ __forceinline__ float act_fp32(float v) {
  if constexpr (kAct == ACT_QUICK)
    return __fdividef(v, 1.0f + __expf(-1.702f * v));
  else
    return apply_act(v, kAct);
}

// One warpgroup's epilogue of a 128 x BN tile at (m0, n0), in 64 x 64
// pieces u (row half u % 2, columns 64 (u / 2)): bias, then the activation
// kAct (none if negative; kPre also stores the pre-activation) or the
// residual (kRes: TMA has put its pieces in the staging buffers, where the
// sums replace them), rounded as the header says, as bf16 into the staging
// buffers, then out by TMA stores. EPI_BIAS_ACT_PRE needs twice the
// buffers, so it goes in rounds of two pieces.
template <int BN, bool kPre, int kAct, bool kRes>
__device__ __forceinline__ void store_tile(
    const float (&acc)[2][BN / 2], unsigned char* staging,
    const bf16* bias_s, const GemmMaps& maps, int M, int N, int m0, int n0,
    int wg) {
  using T = Tile<kBK>;
  constexpr int kPieces = BN / 32;            // 4 or 2
  constexpr int kRound = kPre ? 2 : kPieces;  // pieces a round
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  // this thread's accumulator rows r, r + 8 and column pairs c + 8 q
  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int u0 = 0; u0 < kPieces; u0 += kRound) {
#pragma unroll
    for (int u = u0; u < u0 + kRound; ++u) {
      const int h = u % 2, p = u / 2;
      if (m0 + 64 * h >= M || n0 + 64 * p >= N) continue;  // outside C
      unsigned char* obuf = staging + (u - u0) * T::bytes(64);
      unsigned char* pbuf = obuf + kRound * T::bytes(64);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias_s + 64 * p +
                                                     8 * q + c));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 32 * p + 4 * q + 2 * e;
          float v0 = acc[h][k] + b.x, v1 = acc[h][k + 1] + b.y;
          const uint32_t off = T::offset(64, r + 8 * e, 8 * q + c);
          uint32_t* out = reinterpret_cast<uint32_t*>(obuf + off);
          if constexpr (kPre)
            *reinterpret_cast<uint32_t*>(pbuf + off) = pack_bf16(v0, v1);
          if constexpr (kAct >= 0) {
            v0 = act_fp32<kAct>(v0);
            v1 = act_fp32<kAct>(v1);
          }
          *out = kRes ? add_bf16x2(*out, pack_bf16(v0, v1))
                      : pack_bf16(v0, v1);
        }
      }
    }
    fence_async_smem();  // the stores below read what these threads wrote
    warpgroup_sync(1 + wg);
    if (t == 0) {
#pragma unroll
      for (int u = u0; u < u0 + kRound; ++u) {
        const int row0 = m0 + 64 * (u % 2), nc = n0 + 64 * (u / 2);
        if (row0 >= M || nc >= N) continue;
        unsigned char* obuf = staging + (u - u0) * T::bytes(64);
        tma_store(&maps.c, obuf, nc, row0, 0, 0);
        if constexpr (kPre)
          tma_store(&maps.pre, obuf + kRound * T::bytes(64), nc, row0, 0, 0);
      }
      // a next round rewrites the buffers (a next tile waits at its start)
      if (u0 + kRound < kPieces) tma_store_wait();
    }
    if (u0 + kRound < kPieces) warpgroup_sync(1 + wg);
  }
}

// C[M, N] = epilogue(A[M, K] W[N, K]^T + bias[N]) over `tiles` output tiles
// of 128 x BN (`n_tiles` along N), every operand but the bias through its
// tensor map; `pre` is written only by the kPre instance, which
// EPI_BIAS_ACT_PRE launches. Requires K % 8 == 0, N % 8 == 0 and 16-byte
// aligned bases (checked by the wrapper).
template <int BN, bool kPre>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ GemmMaps maps,
            const bf16* __restrict__ bias, int M, int N, int K, int epi,
            int act, int n_tiles, int tiles) {
  using L = GemmSmem<BN>;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_aligned(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + S;
  uint64_t* turn = empty + S;     // turn[w]: warpgroup w may run its products
  uint64_t* res_full = turn + 2;  // res_full[w]: w's residual pieces are in
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int nk = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the consumer
    }
    mbar_init(&turn[0], 4);
    mbar_init(&turn[1], 4);
    mbar_init(&res_full[0], 1);
    mbar_init(&res_full[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    setmaxnreg_dec<40>();
    if (t == 0) {
      int it = 0;  // stages issued, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S;
          // the consumer's release of this stage's previous use
          if (it >= S) mbar_wait(&empty[s], (it / S - 1) & 1);
          mbar_expect_tx(&full[s], L::kA + L::kW);
          tma_load(smem + L::a + s * L::kA, &maps.a, &full[s], kt * kBK, m0,
                   0, 0);
          tma_load(smem + L::w + s * L::kW, &maps.w, &full[s], kt * kBK, n0,
                   0, 0);
        }
      }
    }
  } else {  // the consumers: the block's tiles i = wg, wg + 2, ...
    setmaxnreg_inc<232>();
    using T = Tile<kBK>;
    const int lane = t % 32;
    unsigned char* staging = smem + L::out + wg * 4 * L::kPiece;
    bf16* bias_s = reinterpret_cast<bf16*>(smem + L::bias) + wg * BN;
    const bool residual = epi == EPI_BIAS_RESIDUAL;
    float acc[2][BN / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
    for (int i = wg, j = 0; blockIdx.x + i * gridDim.x < tiles; i += 2, ++j) {
      const int tile = blockIdx.x + i * gridDim.x;
      const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * BN;
      // The staging buffers are free once the last tile's stores have read
      // them (the barrier before the epilogue passes that on); the
      // residual's pieces arrive there during the products.
      if (t == 0) {
        tma_store_wait();
        if (residual) {
          uint32_t bytes = 0;
          for (int u = 0; u < BN / 32; ++u)
            if (m0 + 64 * (u % 2) < M && n0 + 64 * (u / 2) < N)
              bytes += T::bytes(64);
          mbar_expect_tx(res_full + wg, bytes);
          for (int u = 0; u < BN / 32; ++u)
            if (m0 + 64 * (u % 2) < M && n0 + 64 * (u / 2) < N)
              tma_load(staging + u * T::bytes(64), &maps.res, res_full + wg,
                       n0 + 64 * (u / 2), m0 + 64 * (u % 2), 0, 0);
        }
      }
      if (t < BN) bias_s[t] = n0 + t < N ? bias[n0 + t] : f2bf(0.f);
      // the turn: the other warpgroup has passed its waits on the block's
      // previous tile, so every earlier phase of the full barriers is done
      // and the parities below name this tile's stages
      if (i > 0) mbar_wait(&turn[wg], (wg == 0 ? j - 1 : j) & 1);
      for (int kt = 0; kt < nk; ++kt) {
        const int it = i * nk + kt, s = it % S;
        const uint32_t sa = smem_u32(smem + L::a + s * L::kA);
        const uint32_t sw = smem_u32(smem + L::w + s * L::kW);
        mbar_wait(&full[s], (it / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t b = desc_k<kBK>(sw, BN, 0, kk);
          wgmma_ss<BN>(acc[0], desc_k<kBK>(sa, kBM, 0, kk), b,
                       kt > 0 || kk > 0);
          wgmma_ss<BN>(acc[1], desc_k<kBK>(sa, kBM, 64, kk), b,
                       kt > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
      }
      if (lane == 0) mbar_arrive(&turn[1 - wg]);
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (lane == 0) mbar_arrive(&empty[(i * nk + nk - 1) % S]);

      warpgroup_sync(1 + wg);  // bias_s, and the staging buffers free
      if (residual) mbar_wait(res_full + wg, j & 1);
#define CET_STORE(PRE, ACT, RES)                                         \
  store_tile<BN, PRE, ACT, RES>(acc, staging, bias_s, maps, M, N, m0, n0, \
                                wg)
      if (kPre || epi == EPI_BIAS_ACT) {
        if (act == ACT_QUICK)
          CET_STORE(kPre, ACT_QUICK, false);
        else if (act == ACT_TANH)
          CET_STORE(kPre, ACT_TANH, false);
        else
          CET_STORE(kPre, ACT_ERF, false);
      } else if constexpr (!kPre) {
        if (residual)
          CET_STORE(false, -1, true);
        else
          CET_STORE(false, -1, false);
      }
#undef CET_STORE
    }
    if (t == 0) tma_store_wait();  // the staging outlives the stores' reads
  }
}

template <int BN, bool kPre>
int launch_gemm(const void* a, const void* w, const bf16* bias,
                const void* res, void* C, void* pre, int m, int n, int k,
                int epi, int act, int sms, cudaStream_t stream) {
  using L = GemmSmem<BN>;
  const int bytes = static_cast<int>(L::bytes);
  // also binds the device's context on this thread (autograd's backward
  // thread has none) before the tensor maps are encoded
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<BN, kPre>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  GemmMaps maps;
  const long long mk = static_cast<long long>(m) * k;
  const long long nk = static_cast<long long>(n) * k;
  const long long mn = static_cast<long long>(m) * n;
  int err = make_map(&maps.a, a, k, m, 1, 1, k, mk, mk, kBK, kBM, 128);
  if (!err) err = make_map(&maps.w, w, k, n, 1, 1, k, nk, nk, kBK, BN, 128);
  if (!err) err = make_map(&maps.c, C, n, m, 1, 1, n, mn, mn, 64, 64, 128);
  if (!err && res != nullptr)
    err = make_map(&maps.res, res, n, m, 1, 1, n, mn, mn, 64, 64, 128);
  if (!err && pre != nullptr)
    err = make_map(&maps.pre, pre, n, m, 1, 1, n, mn, mn, 64, 64, 128);
  if (err) return err;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = (m + kBM - 1) / kBM * n_tiles;
  gemm_kernel<BN, kPre><<<std::min(tiles, sms), kThreads, bytes, stream>>>(
      maps, bias, m, n, k, epi, act, n_tiles, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The tile width: 128, or 64 where tiles of 128 would leave more than
// half of the SMs idle (few rows and columns, as the text serving rows of
// a small request), so that twice as many SMs share the products.
int pick_bn(int m, int n, int sms) {
  const long long tiles =
      static_cast<long long>((m + kBM - 1) / kBM) * ((n + 127) / 128);
  return 2 * tiles < sms ? 64 : 128;
}

template <bool kPre>
int dispatch_gemm(const void* a, const void* w, const bf16* bias,
                  const void* res, void* C, void* pre, int m, int n, int k,
                  int epi, int act, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (pick_bn(m, n, sms)) {
    case 128:
      return launch_gemm<128, kPre>(a, w, bias, res, C, pre, m, n, k, epi,
                                    act, sms, stream);
    default:
      return launch_gemm<64, kPre>(a, w, bias, res, C, pre, m, n, k, epi,
                                   act, sms, stream);
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
  if (m <= 0 || n <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cet::bf16* B = static_cast<const cet::bf16*>(bias);
  if (epi == cet::EPI_BIAS_ACT_PRE)
    return cet::dispatch_gemm<true>(a, w, B, nullptr, c, pre, m, n, k, epi,
                                    act, s);
  return cet::dispatch_gemm<false>(
      a, w, B, epi == cet::EPI_BIAS_RESIDUAL ? res : nullptr, c, nullptr, m,
      n, k, epi, act, s);
}

}  // extern "C"
