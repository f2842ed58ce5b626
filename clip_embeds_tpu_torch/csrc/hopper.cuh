// Hopper building blocks of the attention kernels (attention.cu and
// attention_bwd.cu), the bf16 GEMM (fused_block.cu) and the int8 GEMM
// (fused_block_int8.cu): TMA tensor maps built on the host, mbarriers, TMA
// and bulk copies, warpgroup MMA (wgmma) on swizzled shared-memory tiles,
// and register hand-over (setmaxnreg).
//
// Tile layout. A bf16 tile of R rows by D columns sits in shared memory as
// the TMA writes it with a 128-byte swizzle (64 columns a row, D = 64 and
// 128) or a 64-byte one (32 columns, D = 32): `Tile<D>::kPanels` panels of
// kPW columns, each R rows of kSwz bytes, the 16-byte chunks of a row XORed
// with the row's index within its 8-row atom. The same tile is a wgmma
// operand two ways: K-major (rows are M or N, columns are K: the Q, K, V or
// dO of a first product such as Q K^T) and MN-major (rows are K, columns are
// N: the V, K, Q or dO of a second product such as P V).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the entry comes from cudart

#include <algorithm>

#include "common.cuh"

namespace cet {

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda) looked up through the runtime, so that
// the library links no -lcuda.
inline EncodeTiledFn lookup_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

// A rank-4 map of a [B, H, rows, cols] tensor of `type` (bf16, or UINT8
// for int8: TMA moves the bytes either way) read through element strides
// (sb, sh, sn), last dim contiguous, with a box of (box_cols, box_rows) and
// a swizzle of `swizzle` bytes (64 or 128). Rows at or past `rows` read as
// zeros and are dropped on a store. Returns 0 or a cudaError_t. The
// libcuda call needs the device's context current on this thread (autograd
// runs the backward on a thread of its own): call a runtime function
// first, as the launchers' cudaFuncSetAttribute does.
inline int make_map(
    CUtensorMap* map, const void* base, int cols, int rows, int H, int B,
    long long sn, long long sh, long long sb, int box_cols, int box_rows,
    int swizzle,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  static const EncodeTiledFn encode = lookup_encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t esize = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(cols),
                             static_cast<cuuint64_t>(rows),
                             static_cast<cuuint64_t>(H),
                             static_cast<cuuint64_t>(B)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(sn) * esize,
                                static_cast<cuuint64_t>(sh) * esize,
                                static_cast<cuuint64_t>(sb) * esize};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dim, stride, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------- tile layout

template <int D>
struct Tile {
  static constexpr int kSwz = D >= 64 ? 128 : 64;  // bytes of a panel row
  static constexpr int kPW = kSwz / 2;             // columns of a panel
  static constexpr int kPanels = D / kPW;
  static constexpr int kAtom = 8 * kSwz;           // bytes of 8 rows
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : 2;  // wgmma's code
  __host__ __device__ static constexpr uint32_t bytes(int rows) {
    return rows * D * 2;
  }
  __host__ __device__ static constexpr uint32_t panel(int rows) {
    return rows * kSwz;
  }
  // byte offset of element (row, col) in a tile of `rows` rows
  static __device__ __forceinline__ uint32_t offset(int rows, int row,
                                                    int col) {
    const uint32_t x = row * kSwz + (col % kPW) * 2;
    const uint32_t swizzled = x ^ (((x >> 7) & (kSwz / 16 - 1)) << 4);
    return (col / kPW) * panel(rows) + swizzled;
  }
};

// The dynamic shared memory, aligned up to 1024 bytes (the swizzle atom);
// every kernel asks for 1024 bytes more than its layout.
__device__ __forceinline__ unsigned char* smem_aligned(unsigned char* raw) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return raw + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (Tile<D>::kLayout << 62);
}

// K-major operand: rows [r0, r0 + 64) (A) or all `rows` rows (B) of a tile,
// columns [16 kk, 16 kk + 16). The k step moves the start address inside
// the swizzle atom; the leading offset is unused for swizzled K-major.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0,
                                           int kk) {
  using T = Tile<D>;
  const int col = kk * 16;
  return make_desc<D>(tile + (col / T::kPW) * T::panel(rows) + r0 * T::kSwz +
                          (col % T::kPW) * 2,
                      16, T::kAtom);
}

// 8-bit operands in byte terms: a tile of 128 int8 columns has the rows of
// a bf16 tile of 64 (128 bytes, one panel, the 128-byte swizzle), and a k32
// step of 8-bit wgmma is the 32 bytes of a bf16 k16 step. So the K-major
// descriptor of k32 step kk over such a tile is the bf16 one of step kk.
using Tile128B = Tile<64>;

__device__ __forceinline__ uint64_t desc_k_128b(uint32_t tile, int rows,
                                                int r0, int kk) {
  return desc_k<64>(tile, rows, r0, kk);
}

// MN-major operand: rows [16 kk, 16 kk + 16) of a tile as K, all D columns
// as N; the leading offset steps from one panel of columns to the next.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using T = Tile<D>;
  return make_desc<D>(tile + kk * 16 * T::kSwz, T::panel(rows), T::kAtom);
}

// ----------------------------------------------------- mbarriers and copies

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// TMA: the box of `map` at (c0, c1, c2, c3) into shared memory, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA store of a shared-memory box; rows past the map's extent are dropped
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// commit the issuing thread's TMA stores and wait until they have read
// shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// plain bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// make this thread's shared-memory stores visible to the TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of one warpgroup (ids from 1; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Hand registers between warpgroups (warp specialisation): a producer
// lowers its limit, consumers raise theirs, and ptxas allocates the code
// after each within its new limit; all 128 threads execute it.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers in place around the asynchronous MMAs, so that
// the compiler moves no access to them across the issue or the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for int32 accumulators (8-bit products).
template <int R>
__device__ __forceinline__ void fence_regs(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The same for A fragments: keeps them live (unreused) until after the wait.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

// bf16 pair (lo in the low half), the k16 A-fragment element of wgmma
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(r + v) of two bf16 pairs (the GEMMs' residual epilogues)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t r, uint32_t v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16(a.x + b.x, a.y + b.y);
}

// The m64nNk16 fp32 accumulator of a warpgroup: thread (warp w, lane l)
// holds d[i] at row 16 w + l / 4 + 8 ((i >> 1) & 1) and column
// 8 (i >> 2) + 2 (l % 4) + (i & 1). Columns [16 kk, 16 kk + 16) of it are,
// packed in pairs, the A fragment of a k16 step: no shuffle.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], int kk,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a[e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

#define CET_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B, A and B from shared memory, both K-major; N = 32, 64 or
// 128 (the GEMM's W tile, desc_k over `rows` = N). scale_d = 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, "
        "1, 1, 0, 0;\n}\n"
        : CET_D8(0), CET_D8(8), CET_D8(16), CET_D8(24), CET_D8(32),
          CET_D8(40), CET_D8(48), CET_D8(56)
        : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : CET_D8(0), CET_D8(8)
        : "l"(a), "l"(b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : CET_D8(0), CET_D8(8), CET_D8(16), CET_D8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

// d (+)= A B, A from registers (k16 fragment), B from shared memory
// MN-major (the transpose bit); N = 32, 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_rs: N");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : CET_D8(0), CET_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : CET_D8(0), CET_D8(8), CET_D8(16), CET_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : CET_D8(0), CET_D8(8), CET_D8(16), CET_D8(24), CET_D8(32),
          CET_D8(40), CET_D8(48), CET_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
}

#define CET_S8(i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (+)= A B for 8-bit operands, int32 sums: A and B int8 from shared
// memory, both K-major (the only layout 8-bit wgmma takes: no transpose
// bits, no operand scales); N = 64 or 128; desc_k_128b descriptors.
// scale_d = 0 overwrites d. The accumulator layout is acc_to_a's.
template <int N>
__device__ __forceinline__ void wgmma_ss_s8(int32_t (&d)[N / 2], uint64_t a,
                                            uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss_s8: N");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : CET_S8(0), CET_S8(8), CET_S8(16), CET_S8(24), CET_S8(32),
          CET_S8(40), CET_S8(48), CET_S8(56)
        : "l"(a), "l"(b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p;\n}\n"
        : CET_S8(0), CET_S8(8), CET_S8(16), CET_S8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

#undef CET_S8
#undef CET_D8

// Store a warpgroup's [64 x D] fp32 accumulator, times the per-row factor
// of its two rows, as bf16 into a swizzled tile of `rows` rows at row r0
// (the layout a TMA store reads).
template <int D, int R>
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, int rows,
                                            int r0, const float (&d)[R],
                                            float f0, float f1) {
  const int t = threadIdx.x % 128;
  const int row = r0 + 16 * (t / 32) + (t % 32) / 4, c = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int half = (i >> 1) & 1;
    const float f = half ? f1 : f0;
    *reinterpret_cast<uint32_t*>(
        tile + Tile<D>::offset(rows, row + 8 * half, 8 * (i >> 2) + c)) =
        pack_bf16(d[i] * f, d[i + 1] * f);
  }
}

}  // namespace cet
