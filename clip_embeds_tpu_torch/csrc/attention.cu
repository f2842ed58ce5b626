// Exact softmax attention forward, bf16 in and out (the backward is
// attention_bwd.cu).
//
// Replaces the Pallas kernels clip_embeds_tpu/ops/flash_attention.py
// `flash_attention` forward (`_attn_kernel`) and the attention step of
// clip_embeds_tpu/ops/fused_block.py `_kernel` (`_attention`). The TPU
// kernel holds all of K/V for one (batch, head) in VMEM and takes one exact
// row softmax per Q tile; the fused block's non-causal path also skips the
// row max behind a logit clamp at 75. Neither carries over: here one block
// of four warps owns one (b*h, 64-row Q tile) and walks 64-key K/V tiles
// with the standard online-max softmax (fp32 logits and running sums, P
// rounded to bf16 for P.V, fp32 accumulation), which is exact for any
// logit and needs no clamp.
//
// Bound: at ViT-L (N = 577, D = 64) the kernel does 4*N*N*D FLOPs per head
// on 4*N*D*2 bytes of IO, far above the bf16 ridge, so it is compute- and
// latency-bound; the logits never leave shared memory. Masking: keys with
// col >= kv_valid, and col > row when causal (K/V tiles past the Q tile's
// last row are skipped). Strides let one kernel read Q, K and V out of the
// packed [B, n, 3d] qkv buffer of the fused block (head g at columns g*hd,
// d + g*hd, 2d + g*hd) or out of [B, H, N, D] tensors, and write either
// [B, n, d] or [B, H, N, D]. With a non-null `lse` the kernel also writes
// each row's log-sum-exp of its scaled logits (fp32 [B*H, n]), which the
// backward reads to recompute P without a second pass; the serving chain of
// fused_block passes null and skips the store.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace cet {
namespace {

constexpr int kBQ = 64, kBKV = 64, kWarps = 4;
constexpr int kLdS = kBKV + 4;  // fp32 logits row
constexpr int kLdP = kBKV + 8;  // bf16 probabilities row

template <int D>
struct AttnSmem {
  static constexpr int kLdB = D + 8;  // bf16 Q/K/V row
  static constexpr int kLdO = D + 4;  // fp32 output accumulator row
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * kBQ * kLdB;
  static constexpr size_t v = k + sizeof(bf16) * kBKV * kLdB;
  static constexpr size_t s = v + sizeof(bf16) * kBKV * kLdB;
  static constexpr size_t p = s + sizeof(float) * kWarps * 16 * kLdS;
  static constexpr size_t o = p + sizeof(bf16) * kWarps * 16 * kLdP;
  static constexpr size_t bytes = o + sizeof(float) * kWarps * 16 * kLdO;
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int n, int kv_valid,
                 int causal, float scale, long long sb,
                 long long sh, long long sn, long long ob, long long oh,
                 long long on) {
  using L = AttnSmem<D>;
  constexpr int kLdB = L::kLdB, kLdO = L::kLdO, kChunks = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* Sw = reinterpret_cast<float*>(smem + L::s) + warp * 16 * kLdS;
  bf16* Pw = reinterpret_cast<bf16*>(smem + L::p) + warp * 16 * kLdP;
  float* Ow = reinterpret_cast<float*>(smem + L::o) + warp * 16 * kLdO;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kBQ;
  const long long base = b * sb + h * sh;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  for (int c = tid; c < kBQ * kChunks; c += kWarps * 32) {
    int r = c / kChunks, cc = (c % kChunks) * 8;
    int gr = q0 + r;
    bool ok = gr < n;
    cp_async16(&Qs[r * kLdB + cc], qb + (ok ? gr : 0) * sn + cc, ok);
  }
  cp_async_commit();
  for (int e = lane; e < 16 * kLdO; e += 32) Ow[e] = 0.f;

  // Softmax state of one query row, kept by the two lanes that share it.
  const int r = lane / 2, half = lane % 2;
  const int qrow = q0 + warp * 16 + r;
  float m_i = -INFINITY, l_i = 0.f;

  const int kv_lim = min(n, kv_valid);  // keys at or past this are masked
  const int kv_end = causal ? min(kv_lim, q0 + kBQ) : kv_lim;
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < kBKV * kChunks; c += kWarps * 32) {
      int rr = c / kChunks, cc = (c % kChunks) * 8;
      int gr = k0 + rr;
      bool ok = gr < kv_end;
      long long off = (ok ? gr : 0) * sn + cc;
      cp_async16(&Ks[rr * kLdB + cc], kb + off, ok);
      cp_async16(&Vs[rr * kLdB + cc], vb + off, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T for this warp's 16 query rows.
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_acc;
      wmma::fill_fragment(s_acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(qa, &Qs[(warp * 16) * kLdB + kk * 16], kLdB);
        wmma::load_matrix_sync(kf, &Ks[(j * 16) * kLdB + kk * 16], kLdB);
        wmma::mma_sync(s_acc, qa, kf, s_acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, s_acc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on row r; each lane of the pair takes 32 columns.
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c, kc = k0 + col;
      const bool ok = kc < kv_lim && (!causal || kc <= qrow);
      const float s = ok ? Sw[r * kLdS + col] * scale : -INFINITY;
      Sw[r * kLdS + col] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const bool none = m_new == -INFINITY;  // no valid key seen yet
    const float alpha = none ? 1.f : expf(m_i - m_new);
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const float p = none ? 0.f : expf(Sw[r * kLdS + col] - m_new);
      Pw[r * kLdP + col] = f2bf(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    for (int c = 0; c < D / 2; ++c) Ow[r * kLdO + half * (D / 2) + c] *= alpha;
    __syncwarp();

    // O += P V
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_acc;
      wmma::load_matrix_sync(o_acc, Ow + j * 16, kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pa, Pw + kk * 16, kLdP);
        wmma::load_matrix_sync(vf, &Vs[(kk * 16) * kLdB + j * 16], kLdB);
        wmma::mma_sync(o_acc, pa, vf, o_acc);
      }
      wmma::store_matrix_sync(Ow + j * 16, o_acc, kLdO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (qrow < n) {
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    bf16* orow = o + b * ob + h * oh + qrow * on + half * (D / 2);
    const float* src = Ow + r * kLdO + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      __align__(16) bf16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = f2bf(src[c + e] * inv);
      *reinterpret_cast<uint4*>(orow + c) = *reinterpret_cast<uint4*>(out);
    }
    // a row with no valid key gets +inf, so exp(s - lse) = 0 in the backward
    if (lse != nullptr && half == 0)
      lse[static_cast<long long>(blockIdx.x) * n + qrow] =
          l_i > 0.f ? m_i + logf(l_i) : INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int n, int kv_valid, int causal, float scale,
           long long sb, long long sh, long long sn, long long ob,
           long long oh, long long on, cudaStream_t stream) {
  const int bytes = static_cast<int>(AttnSmem<D>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (n + kBQ - 1) / kBQ);  // b*h on x: no 65535 limit
  attention_kernel<D><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, n, kv_valid, causal, scale, sb, sh, sn, ob,
      oh, on);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cet

extern "C" int cet_attention(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int n, int D,
                             int kv_valid, int causal, float scale, long long sb,
                             long long sh, long long sn, long long ob,
                             long long oh, long long on, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return cet::launch<32>(q, k, v, o, lse, B, H, n, kv_valid, causal,
                             scale, sb, sh, sn, ob, oh, on, s);
    case 64:
      return cet::launch<64>(q, k, v, o, lse, B, H, n, kv_valid, causal,
                             scale, sb, sh, sn, ob, oh, on, s);
    case 128:
      return cet::launch<128>(q, k, v, o, lse, B, H, n, kv_valid, causal,
                              scale, sb, sh, sn, ob, oh, on, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
