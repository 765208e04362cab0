// Attention sub-block of the CLIP ViT at eval: out = x + out_proj(MHA(LN1(x))).
//
// Replaces the Pallas kernel demo2_tpu/ops/fused_block.py::_fwd_kernel_infer
// (reached through _fused_infer_impl), with its numerics:
//   * LN1 statistics in f32 (centered two-pass variance), t rounded to bf16;
//   * qkv = bf16(t @ Wqkv^T + bqkv) with f32 accumulation and f32 bias;
//   * scores in f32, keys >= S masked (here: never visited), softmax in f32
//     with +1e-30 in the denominator, p normalised then rounded to bf16;
//   * attn = bf16(p @ v) with f32 accumulation;
//   * y = bf16(attn @ Wout^T + bout); out = bf16(x + y)  (residual in bf16).
//
// Design: four launches on the caller's stream.
//   1. layernorm_kernel: t = LN1(x) in bf16, once per row;
//   2. gemm_bf16_kernel with a bias epilogue -> qkv (M, 3C);
//   3. attention_kernel: one 128-thread block per (query tile of 16 rows,
//      head, sample).  The head's K, then V, sit in shared memory
//      (<= 144 x 64 bf16 = 18 KB at a time), the 16 x S_pad f32 score tile
//      beside them; QK^T and PV run on the tensor cores (wmma), the softmax
//      on CUDA cores, one warp per 4 query rows;
//   4. gemm_bf16_kernel with a bias + bf16-residual epilogue -> out.
//
// What bounds it on an H100: at the flagship shape (M = 192 x 129 rows,
// C = 768, 12 heads of 64) the two projections are 2 x 24768 x 768 x
// (3 x 768 + 768) ~ 0.12 TFLOP of bf16 tensor-core work, far above the card's
// ~295 FLOP/byte ridge, so the GEMMs are compute-bound; attention itself is
// ~10 GFLOP on 33 KB of K/V per (sample, head) and is bound by the shared-
// memory traffic of the simple wmma tiles.  What the TPU kept in VMEM, t and
// attn (38 MB each) and qkv (114 MB), here pass through device memory:
// fusing steps 1-4 so that none of them leaves the SM is the first thing a
// later PR does.

#include <mma.h>

#include "gemm.cuh"

namespace demo2 {
namespace {

constexpr int kHeadDim = 64;
constexpr int kQTile = 16;     // query rows per block (one wmma tile)
constexpr int kMaxSeq = 144;   // keys, padded to 16; the flagship has 129
constexpr int kLdQK = kHeadDim + 8;
constexpr int kLdS = kMaxSeq + 4;
constexpr int kLdP = kMaxSeq + 8;
constexpr int kAttnThreads = 128;

// qkv: (B*S, 3C) rows, q | k | v, each head-major (H, 64) inside its C slice.
// out: (B*S, C).
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int S, int C,
                 float scale) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 q_s[kQTile * kLdQK];
  __shared__ __align__(128) bf16 kv_s[kMaxSeq * kLdQK];
  __shared__ __align__(128) float s_s[kQTile * kLdS];
  __shared__ __align__(128) bf16 p_s[kQTile * kLdP];

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s_pad = (S + 15) & ~15;
  const size_t ld = 3 * static_cast<size_t>(C);
  const bf16* base = qkv + static_cast<size_t>(b) * S * ld + h * kHeadDim;

  // Q tile: 16 rows x 8 vectors of 8 = one vector per thread.
  {
    const int r = tid >> 3;
    const int c = (tid & 7) * 8;
    const uint4 v = (q0 + r < S) ? *reinterpret_cast<const uint4*>(base + (q0 + r) * ld + c)
                                 : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(&q_s[r * kLdQK + c]) = v;
  }
  auto load_head = [&](int offset) {  // K (offset C) or V (offset 2C), zero rows past S
    for (int i = tid; i < s_pad * 8; i += kAttnThreads) {
      const int r = i >> 3;
      const int c = (i & 7) * 8;
      const uint4 v = (r < S) ? *reinterpret_cast<const uint4*>(base + r * ld + offset + c)
                              : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&kv_s[r * kLdQK + c]) = v;
    }
  };
  load_head(C);
  __syncthreads();

  // Scores: the warps split the S_pad / 16 key tiles.
  for (int nt = warp; nt < s_pad / 16; nt += kAttnThreads / 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kHeadDim; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
      wmma::load_matrix_sync(fq, q_s + kk, kLdQK);
      wmma::load_matrix_sync(fk, kv_s + nt * 16 * kLdQK + kk, kLdQK);
      wmma::mma_sync(acc, fq, fk, acc);
    }
    wmma::store_matrix_sync(s_s + nt * 16, acc, kLdS, wmma::mem_row_major);
  }
  __syncthreads();

  load_head(2 * C);  // V replaces K; the softmax below only touches s_s / p_s.

  // Softmax: warp w owns query rows 4w .. 4w+3.
#pragma unroll
  for (int rr = 0; rr < kQTile / 4; ++rr) {
    const int r = warp * (kQTile / 4) + rr;
    float* srow = s_s + r * kLdS;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float v = srow[j] * scale;
      srow[j] = v;
      m = fmaxf(m, v);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    const float denom = warp_sum(sum) + 1e-30f;
    for (int j = lane; j < s_pad; j += 32) {
      p_s[r * kLdP + j] = __float2bfloat16_rn(j < S ? srow[j] / denom : 0.f);
    }
  }
  __syncthreads();

  // O = P V: warp w owns output columns 16w .. 16w+15; staged through s_s.
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < s_pad; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
      wmma::load_matrix_sync(fp, p_s + kk, kLdP);
      wmma::load_matrix_sync(fv, kv_s + kk * kLdQK + warp * 16, kLdQK);
      wmma::mma_sync(acc, fp, fv, acc);
    }
    wmma::store_matrix_sync(s_s + warp * 16, acc, kLdS, wmma::mem_row_major);
  }
  __syncthreads();

  {
    const int r = tid >> 3;
    const int c = (tid & 7) * 8;
    if (q0 + r < S) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = s_s[r * kLdS + c + i];
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * S + q0 + r) * C +
                                h * kHeadDim + c) = pack8(f);
    }
  }
}

}  // namespace
}  // namespace demo2

// Plain C entry, loaded with ctypes.  Pointers are device pointers; x, out,
// qkv and attn are row-major bf16, the LayerNorm and bias vectors f32, the
// weights bf16 in torch's Linear layout (out, in).  t and attn are (B*S, C)
// and qkv (B*S, 3C) bf16 scratch.  Returns the first
// non-zero cudaGetLastError() of the launches, else 0.
extern "C" int demo2_fused_attention_block(const void* x, const void* ln_scale,
                                           const void* ln_bias, const void* wqkv,
                                           const void* bqkv, const void* wout,
                                           const void* bout, void* out, void* t, void* qkv,
                                           void* attn, int batch, int seq, int width, int heads,
                                           float scale, void* stream) {
  using namespace demo2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = batch * seq;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* tb = static_cast<bf16*>(t);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* attnb = static_cast<bf16*>(attn);

  cudaError_t err = launch_layernorm(xb, static_cast<const float*>(ln_scale),
                                     static_cast<const float*>(ln_bias), tb, rows, width, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_gemm(tb, static_cast<const bf16*>(wqkv), rows, 3 * width, width,
                    BiasEpilogue{qkvb, static_cast<const float*>(bqkv), 3 * width}, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((seq + kQTile - 1) / kQTile, heads, batch);
  attention_kernel<<<grid, kAttnThreads, 0, st>>>(qkvb, attnb, seq, width, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_gemm(attnb, static_cast<const bf16*>(wout), rows, width, width,
                    BiasResidualBf16Epilogue{static_cast<bf16*>(out),
                                             static_cast<const float*>(bout), xb, width},
                    st);
  return static_cast<int>(err);
}

// Compile-time limits the Python wrapper checks before launching.
extern "C" int demo2_attention_head_dim() { return demo2::kHeadDim; }
extern "C" int demo2_attention_max_seq() { return demo2::kMaxSeq; }

extern "C" const char* demo2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
