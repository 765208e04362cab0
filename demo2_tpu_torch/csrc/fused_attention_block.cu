// Attention sub-block of the CLIP ViT: out = x + out_proj(MHA(LN1(x))), at
// eval and, with its training residuals, in training.
//
// Replaces the Pallas kernels demo2_tpu/ops/fused_block.py::_fwd_kernel_infer
// (eval, reached through _fused_infer_impl) and ::_fwd_kernel (training,
// reached through _fused_fwd_impl), with their numerics:
//   * LN1 statistics in f32 (centered two-pass variance), t rounded to bf16;
//   * qkv = bf16(t @ Wqkv^T + bqkv) with f32 accumulation and f32 bias;
//   * scores in f32, keys >= S masked (here: never visited), softmax in f32
//     with +1e-30 in the denominator, p normalised then rounded to bf16;
//   * attn = bf16(p @ v) with f32 accumulation;
//   * y = bf16(attn @ Wout^T + bout); out = bf16(x + y)  (residual in bf16).
// The training entry also keeps qkv and attn (which the eval entry writes as
// scratch) and stores the bf16 p of every (sample, head) in the probs layout
// of demo2_tpu_torch/ops/packed_attention.py: (B, H, S, S16), S16 = S rounded
// up to 16, columns >= S zero.  That is the layout attention_bwd.cuh reads.
//
// Design: four launches on the caller's stream.
//   1. layernorm_kernel: t = LN1(x) in bf16, once per row;
//   2. gemm_bf16_kernel with a bias epilogue -> qkv (M, 3C);
//   3. attention_fwd_kernel<Softmax::kNormBeforePV> (attention_fwd.cuh):
//      one 128-thread block per (query tile of 16 rows, head, sample), K
//      then V of the head in shared memory, QK^T and PV on the tensor cores
//      (wmma), the softmax on CUDA cores;
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

#include "attention_fwd.cuh"
#include "gemm.cuh"

namespace demo2 {
namespace {

// The four launches; probs == nullptr is the eval path (no probs store).
cudaError_t attention_block(const bf16* x, const float* ln_scale, const float* ln_bias,
                            const bf16* wqkv, const float* bqkv, const bf16* wout,
                            const float* bout, bf16* out, bf16* t, bf16* qkv, bf16* attn,
                            bf16* probs, int batch, int seq, int width, int heads, float scale,
                            cudaStream_t st) {
  const int rows = batch * seq;
  cudaError_t err = launch_layernorm(x, ln_scale, ln_bias, t, rows, width, st);
  if (err != cudaSuccess) return err;

  err = launch_gemm(t, wqkv, rows, 3 * width, width, BiasEpilogue{qkv, bqkv, 3 * width}, st);
  if (err != cudaSuccess) return err;

  const HeadLayout in = packed_layout(seq, width), ol = rows_layout(seq, width);
  err = probs != nullptr
            ? launch_attention_fwd<Softmax::kNormBeforePV, true>(
                  qkv, qkv + width, qkv + 2 * width, in, attn, ol, probs, batch, seq, heads,
                  scale, st)
            : launch_attention_fwd<Softmax::kNormBeforePV, false>(
                  qkv, qkv + width, qkv + 2 * width, in, attn, ol, nullptr, batch, seq, heads,
                  scale, st);
  if (err != cudaSuccess) return err;

  return launch_gemm(attn, wout, rows, width, width,
                     BiasResidualBf16Epilogue{out, bout, x, width}, st);
}

}  // namespace
}  // namespace demo2

// Plain C entries, loaded with ctypes.  Pointers are device pointers; x, out,
// qkv and attn are row-major bf16, the LayerNorm and bias vectors f32, the
// weights bf16 in torch's Linear layout (out, in).  t and attn are (B*S, C)
// and qkv (B*S, 3C) bf16.  Each returns the first non-zero cudaGetLastError()
// of its launches, else 0.
//
// Eval (kernel 1): t, qkv and attn are scratch.
extern "C" int demo2_fused_attention_block(const void* x, const void* ln_scale,
                                           const void* ln_bias, const void* wqkv,
                                           const void* bqkv, const void* wout,
                                           const void* bout, void* out, void* t, void* qkv,
                                           void* attn, int batch, int seq, int width, int heads,
                                           float scale, void* stream) {
  using namespace demo2;
  return static_cast<int>(attention_block(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wout),
      static_cast<const float*>(bout), static_cast<bf16*>(out), static_cast<bf16*>(t),
      static_cast<bf16*>(qkv), static_cast<bf16*>(attn), nullptr, batch, seq, width, heads,
      scale, static_cast<cudaStream_t>(stream)));
}

// Training (kernel 3): qkv and attn are the residuals the backward reads, and
// probs (B, H, S, S16) bf16 receives the normalised probabilities.
extern "C" int demo2_fused_attention_block_train(const void* x, const void* ln_scale,
                                                 const void* ln_bias, const void* wqkv,
                                                 const void* bqkv, const void* wout,
                                                 const void* bout, void* out, void* t,
                                                 void* qkv, void* attn, void* probs, int batch,
                                                 int seq, int width, int heads, float scale,
                                                 void* stream) {
  using namespace demo2;
  return static_cast<int>(attention_block(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wout),
      static_cast<const float*>(bout), static_cast<bf16*>(out), static_cast<bf16*>(t),
      static_cast<bf16*>(qkv), static_cast<bf16*>(attn), static_cast<bf16*>(probs), batch, seq,
      width, heads, scale, static_cast<cudaStream_t>(stream)));
}

// Compile-time limits of every attention tile (kernels 1, 3-7, 9 and 10),
// which the Python wrappers check before launching.
extern "C" int demo2_attention_head_dim() { return demo2::kHeadDim; }
extern "C" int demo2_attention_max_seq() { return demo2::kMaxSeq; }

extern "C" const char* demo2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
