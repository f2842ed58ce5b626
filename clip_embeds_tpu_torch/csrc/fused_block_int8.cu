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
// not rounded to bf16 first (`_kernel_int8`, unlike the bf16 block), and
// taken with common.cuh's apply_act (IEEE exp and division, not the bf16
// GEMM's fast quick GELU: a code that flips moves every later sum). The
// dequantisation is (float(acc) * (a * s)) + b with no fused multiply-add,
// the plain version's order (ops/fused_block.py gemm_s8_reference). `a` is
// the block's four static activation scales (qkv, out, fc, proj), read
// from device memory: no host sync. The int32 sums are exact, so the bf16
// and residual epilogues are bit-equal to the plain version on the card.
//
// Bound: the four projections are 24 * n * d^2 int8 ops per sequence, far
// above the H100's ridge (1,979 TOPS int8 dense, twice the bf16 rate, on
// 3.35 TB/s), so the GEMM is compute-bound (the out-projection, with its
// bf16 residual read and bf16 output, is bound by its bytes); the LN and
// quantise passes are bandwidth-bound (one bf16 read, one int8 write).
// Design of the GEMM, C[M, N] = epilogue(A[M, K] W[N, K]^T), the bf16
// GEMM's (fused_block.cu) on 8-bit operands. A (int8 activation rows) and
// W (the int8 [out, in] weight) are both K-major, the only layout 8-bit
// wgmma takes, so each arrives by TMA as 128-byte-wide K tiles (128 int8
// values) with the 128-byte swizzle and feeds wgmma m64nBNk32 .s32.s8.s8
// straight from shared memory. Output tiles are 128 x BN (BN = 128, or 64
// for int8 output and where tiles of 128 would leave most SMs idle), K in
// stages of 128:
// - warpgroup 2 produces: one thread keeps a ring of (A, W) tile pairs in
//   flight on full/empty mbarriers, tile after tile, and the warpgroup
//   hands most of its registers to the consumers (setmaxnreg);
// - warpgroups 0 and 1 take the block's tiles in turn (ping-pong, a turn
//   barrier passes the products), so one tile's epilogue runs under the
//   other's products: four k32 steps of two 64-row halves a stage, then
//   wgmma_wait<1>, and the stage before goes back to the producer;
// - the epilogue works on the int32 accumulators in registers: the column
//   factors a * s and the biases (fp32) sit in shared memory, the
//   residual's 64 x 64 bf16 pieces come by TMA into the staging buffers
//   during the products; bf16 results go out as 64 x 64 pieces (128-byte
//   swizzle), int8 codes as pieces of 64 rows of 64 bytes (64-byte
//   swizzle), by TMA. The int8 codes are computed branch-free and the few
//   near a rounding boundary recomputed exactly (store_tile_s8);
// - the grid is persistent, one block per SM walking the output tiles with
//   N fastest.
// TMA zero-fills rows past M and N and columns past K (zeros add nothing to
// the sum) and drops stores past them. No split-K and no atomics: two calls
// are bit-equal.

#include "hopper.cuh"

namespace cet {
namespace {

constexpr int kBM = 128, kBK = 128;  // tile rows; K of a stage (int8 = bytes)
constexpr int kThreads = 384;        // two consumer warpgroups, one producer
constexpr uint32_t kSmemMax = 232448;  // dynamic shared memory of a block

enum Epilogue { EPI_BF16 = 0, EPI_ACT_Q8 = 1, EPI_RESIDUAL = 2 };

__device__ __forceinline__ int8_t quantize(float v, float a) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, a)), -127.f), 127.f);
  return static_cast<int8_t>(q);
}

__device__ __forceinline__ float dequantize(int acc, float scale, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(acc), scale), b);
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

struct GemmS8Maps {
  CUtensorMap a, w, c, res;  // c: bf16 or int8 output; res only where given
};

// Shared memory of a block: the ring (4 to 6 stages of a 128-row A tile
// and a BN-row W tile, 128 bytes of K each: as many as fit beside the
// rest), four 8 KB staging pieces a consumer warpgroup (64 x 64 bf16 in
// the 128-byte swizzle; an int8 piece, 64 rows of 64 bytes, takes the
// first 4 KB of one), the fp32 column factors a * s and biases of each
// consumer's tile, the barriers.
template <int BN>
struct GemmS8Smem {
  using T = Tile128B;
  static constexpr uint32_t kA = T::bytes(kBM);
  static constexpr uint32_t kW = T::bytes(BN);
  static constexpr uint32_t kPiece = T::bytes(64);
  static constexpr uint32_t kOut = 8 * kPiece;
  static constexpr uint32_t kVec = 2 * 2 * BN * 4;
  static constexpr int kStages =
      (kSmemMax - kOut - kVec - (2 * 8 + 4) * 8 - 1024) / (kA + kW);
  static constexpr uint32_t a = 0;
  static constexpr uint32_t w = a + kStages * kA;
  static constexpr uint32_t out = w + kStages * kW;
  static constexpr uint32_t vec = out + kOut;
  static constexpr uint32_t bar = vec + kVec;  // full, empty, turn, res
  static constexpr uint32_t bytes = bar + (2 * kStages + 4) * 8 + 1024;
  static_assert(kStages >= 4 && kStages <= 8 && bytes <= kSmemMax, "smem");
};

// a / b to within 2 ulp over the full range, without the branch to the
// slow path that an IEEE division takes (div.full.f32)
__device__ __forceinline__ float div_full(float a, float b) {
  float d;
  asm("div.full.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// act(v) / a branch-free, so that the epilogue's codes are computed side
// by side: quick GELU as v / ((1 + e) a) in one div_full, the others as
// div_full(apply_act(v), a). Within 4 ulp of the quotient that
// quantize(apply_act(v), a) rounds (the exponential is the same).
template <int kAct>
__device__ __forceinline__ float act_quotient_fast(float v, float a) {
  if constexpr (kAct == ACT_QUICK)
    return div_full(v, (1.0f + expf(-1.702f * v)) * a);
  else
    return div_full(apply_act(v, kAct), a);
}

// The int8 code of quotient t as quantize gives it; sets `near` where t
// lies within 2^-18 |t| (far above the 4 ulp) of a rounding boundary, the
// only place the exact quotient can round to another code
__device__ __forceinline__ int8_t code_of(float t, bool& near) {
  const float r = rintf(t);
  near = fabsf(fabsf(t - r) - 0.5f) <= fabsf(t) * 0x1p-18f;
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// Byte offset of the int8 code at (row, col), col even, in a staging piece
// of 64 rows of 64 bytes with the 64-byte swizzle: byte for byte the
// layout of a 64 x 32 bf16 tile, column col / 2.
__device__ __forceinline__ uint32_t s8_piece_offset(int row, int col) {
  return Tile<32>::offset(64, row, col / 2);
}

// One warpgroup's epilogue of a 128 x BN tile at (m0, n0), in 64 x 64
// pieces u (row half u % 2, columns 64 (u / 2)): each int32 sum
// dequantised with its column's factor and bias (sc_s, bias_s), then
// rounded to bf16 (EPI_BF16), added to the residual that TMA has put in the
// staging piece (EPI_RESIDUAL: bf16(r + bf16(v)), the sum replaces it), or
// taken through the activation kAct and quantised with a_next
// (EPI_ACT_Q8, int8 pieces); then out by TMA stores. EPI_ACT_Q8 computes
// a piece's 32 codes of a thread branch-free (act_quotient_fast), which
// with one warp per scheduler is what keeps it from waiting on each
// division in turn, and then recomputes exactly (quantize(apply_act))
// the few whose quotient lies near a rounding boundary: the codes are
// those of the exact expression.
template <int BN, int kEpi, int kAct>
__device__ __forceinline__ void store_tile_s8(
    const int32_t (&acc)[2][BN / 2], unsigned char* staging,
    const float* __restrict__ sc_s, const float* __restrict__ bias_s,
    float a_next,
    const GemmS8Maps& maps, int M, int N, int m0, int n0, int wg) {
  using T = Tile128B;
  constexpr int kPieces = BN / 32;  // 4 or 2
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  // this thread's accumulator rows r, r + 8 and column pairs c + 8 q
  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int u = 0; u < kPieces; ++u) {
    const int h = u % 2, p = u / 2;
    if (m0 + 64 * h >= M || n0 + 64 * p >= N) continue;  // outside C
    unsigned char* buf = staging + u * T::bytes(64);
    uint32_t near_mask = 0;  // bit 4 q + 2 e + j: code (r + 8 e, 8 q + c + j)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = 64 * p + 8 * q + c;
      const float2 s = *reinterpret_cast<const float2*>(sc_s + col);
      const float2 b = *reinterpret_cast<const float2*>(bias_s + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 32 * p + 4 * q + 2 * e;
        const float v0 = dequantize(acc[h][k], s.x, b.x);
        const float v1 = dequantize(acc[h][k + 1], s.y, b.y);
        if constexpr (kEpi == EPI_ACT_Q8) {
          bool near0, near1;
          const uint8_t c0 = code_of(act_quotient_fast<kAct>(v0, a_next),
                                     near0);
          const uint8_t c1 = code_of(act_quotient_fast<kAct>(v1, a_next),
                                     near1);
          near_mask |= (near0 ? 1u : 0u) << (4 * q + 2 * e);
          near_mask |= (near1 ? 2u : 0u) << (4 * q + 2 * e);
          // a 16-bit store: unlike a char one, it cannot alias the fp32
          // factors, so the next ones load while these codes compute
          *reinterpret_cast<uint16_t*>(
              buf + s8_piece_offset(r + 8 * e, 8 * q + c)) = c0 | c1 << 8;
        } else {
          uint32_t* out = reinterpret_cast<uint32_t*>(
              buf + T::offset(64, r + 8 * e, 8 * q + c));
          *out = kEpi == EPI_RESIDUAL ? add_bf16x2(*out, pack_bf16(v0, v1))
                                      : pack_bf16(v0, v1);
        }
      }
    }
    if constexpr (kEpi == EPI_ACT_Q8) {
      while (near_mask) {  // rare: 2^-17 |t| of the codes, under 1e-3
        const int i = __ffs(near_mask) - 1;
        near_mask &= near_mask - 1;
        int32_t sum = 0;  // acc[h][32 p + i], with no dynamic register index
#pragma unroll
        for (int x = 0; x < 32; ++x) sum = x == i ? acc[h][32 * p + x] : sum;
        const int q = i >> 2, e = (i >> 1) & 1, j = i & 1;
        const int col = 64 * p + 8 * q + c + j;
        buf[s8_piece_offset(r + 8 * e, 8 * q + c) + j] = quantize(
            apply_act(dequantize(sum, sc_s[col], bias_s[col]), kAct), a_next);
      }
    }
  }
  fence_async_smem();  // the stores below read what these threads wrote
  warpgroup_sync(1 + wg);
  if (t == 0) {
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int row0 = m0 + 64 * (u % 2), nc = n0 + 64 * (u / 2);
      if (row0 < M && nc < N)
        tma_store(&maps.c, staging + u * T::bytes(64), nc, row0, 0, 0);
    }
  }
}

// C[M, N] = epilogue(A[M, K] W[N, K]^T) over `tiles` output tiles of
// 128 x BN (`n_tiles` along N), A, W, C and the residual through their
// tensor maps; the column scales, biases and activation scales are read by
// element, and a null `bias` adds nothing. Requires K % 16 == 0, N % 16 == 0 for int8 output (% 8 for
// bf16) and 16-byte aligned bases (checked by the wrapper).
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_s8_kernel(const __grid_constant__ GemmS8Maps maps,
               const float* __restrict__ wscale,
               const float* __restrict__ bias,
               const float* __restrict__ act_scales, int a_idx, int M, int N,
               int K, int epi, int act, int n_tiles, int tiles) {
  using L = GemmS8Smem<BN>;
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
    using T = Tile128B;
    const int lane = t % 32;
    unsigned char* staging = smem + L::out + wg * 4 * L::kPiece;
    float* sc_s = reinterpret_cast<float*>(smem + L::vec) + wg * 2 * BN;
    float* bias_s = sc_s + BN;
    const bool residual = epi == EPI_RESIDUAL;
    const float a = act_scales[a_idx];
    const float a_next = epi == EPI_ACT_Q8 ? act_scales[a_idx + 1] : 1.f;
    int32_t acc[2][BN / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0;
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
      if (t < BN) {
        const bool in = n0 + t < N;
        sc_s[t] = in ? __fmul_rn(a, wscale[n0 + t]) : 0.f;
        bias_s[t] = in && bias ? bias[n0 + t] : 0.f;
      }
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
        for (int kk = 0; kk < kBK / 32; ++kk) {
          const uint64_t b = desc_k_128b(sw, BN, 0, kk);
          wgmma_ss_s8<BN>(acc[0], desc_k_128b(sa, kBM, 0, kk), b,
                          kt > 0 || kk > 0);
          wgmma_ss_s8<BN>(acc[1], desc_k_128b(sa, kBM, 64, kk), b,
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

      warpgroup_sync(1 + wg);  // the factors, and the staging buffers free
      if (residual) mbar_wait(res_full + wg, j & 1);
#define CET_STORE(EPI, ACT)                                                \
  store_tile_s8<BN, EPI, ACT>(acc, staging, sc_s, bias_s, a_next, maps, M, \
                              N, m0, n0, wg)
      if (epi == EPI_ACT_Q8) {
        if (act == ACT_QUICK)
          CET_STORE(EPI_ACT_Q8, ACT_QUICK);
        else if (act == ACT_TANH)
          CET_STORE(EPI_ACT_Q8, ACT_TANH);
        else
          CET_STORE(EPI_ACT_Q8, ACT_ERF);
      } else if (residual) {
        CET_STORE(EPI_RESIDUAL, -1);
      } else {
        CET_STORE(EPI_BF16, -1);
      }
#undef CET_STORE
    }
    if (t == 0) tma_store_wait();  // the staging outlives the stores' reads
  }
}

template <int BN>
int launch_gemm_s8(const void* a, const void* w, const float* wscale,
                   const float* bias, const float* act_scales, int a_idx,
                   const void* res, void* C, int m, int n, int k, int epi,
                   int act, int sms, cudaStream_t stream) {
  using L = GemmS8Smem<BN>;
  const int bytes = static_cast<int>(L::bytes);
  // also binds the device's context on this thread before the tensor maps
  // are encoded
  cudaError_t e = cudaFuncSetAttribute(
      gemm_s8_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr CUtensorMapDataType kS8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  GemmS8Maps maps;
  const long long mk = static_cast<long long>(m) * k;
  const long long nk = static_cast<long long>(n) * k;
  const long long mn = static_cast<long long>(m) * n;
  int err = make_map(&maps.a, a, k, m, 1, 1, k, mk, mk, kBK, kBM, 128, kS8);
  if (!err)
    err = make_map(&maps.w, w, k, n, 1, 1, k, nk, nk, kBK, BN, 128, kS8);
  if (!err)
    err = epi == EPI_ACT_Q8
              ? make_map(&maps.c, C, n, m, 1, 1, n, mn, mn, 64, 64, 64, kS8)
              : make_map(&maps.c, C, n, m, 1, 1, n, mn, mn, 64, 64, 128);
  if (!err && res != nullptr)
    err = make_map(&maps.res, res, n, m, 1, 1, n, mn, mn, 64, 64, 128);
  if (err) return err;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = (m + kBM - 1) / kBM * n_tiles;
  gemm_s8_kernel<BN><<<std::min(tiles, sms), kThreads, bytes, stream>>>(
      maps, wscale, bias, act_scales, a_idx, m, n, k, epi, act, n_tiles,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

// The tile width: 128, or 64 where tiles of 128 would leave more than half
// of the SMs idle (the bf16 GEMM's rule), and for int8 output, whose
// epilogue costs more than a tile's products: its halves interleave more
// finely with the other consumer's products (the --tiles sweep, PERF.md).
int pick_bn(int m, int n, int epi, int sms) {
  const long long tiles =
      static_cast<long long>((m + kBM - 1) / kBM) * ((n + 127) / 128);
  return epi == EPI_ACT_Q8 || 2 * tiles < sms ? 64 : 128;
}

int dispatch_gemm_s8(const void* a, const void* w, const float* wscale,
                     const float* bias, const float* act_scales, int a_idx,
                     const void* res, void* C, int m, int n, int k, int epi,
                     int act, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (pick_bn(m, n, epi, sms)) {
    case 128:
      return launch_gemm_s8<128>(a, w, wscale, bias, act_scales, a_idx, res,
                                 C, m, n, k, epi, act, sms, stream);
    default:
      return launch_gemm_s8<64>(a, w, wscale, bias, act_scales, a_idx, res,
                                C, m, n, k, epi, act, sms, stream);
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
  if (m <= 0 || n <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return cet::dispatch_gemm_s8(
      a, w, static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<const float*>(act_scales), a_idx,
      epi == cet::EPI_RESIDUAL ? res : nullptr, c, m, n, k, epi, act,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
