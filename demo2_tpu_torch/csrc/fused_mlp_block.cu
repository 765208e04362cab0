// MLP sub-block of the CLIP ViT: out = x + fc2(QuickGELU(fc1(LN2(x)))), at
// eval and, with the pre-GELU hidden as a second output, in training.
//
// Replaces the Pallas kernel demo2_tpu/ops/fused_block.py::_mlp_kernel
// (kernel 2, reached through _fused_mlp_fwd_impl / fused_mlp_block), with its
// numerics:
//   * LN2 statistics in f32 (centered two-pass variance), t rounded to bf16;
//   * h = t @ W1^T + b1 in f32; g = bf16(h * sigmoid(1.702 h)) from f32 h;
//   * y = g @ W2^T + b2 in f32; out = bf16(f32(x) + y)  (residual in f32).
// The Pallas kernel always writes the pre-GELU h as well, h rounded to bf16
// from the f32 product + bias, which only the training VJP reads
// (fused_block.py::_fused_mlp_bwd).  Here that is the training entry's,
// demo2_fused_mlp_block_train; the eval entry does not write it.
//
// Design: three launches on the caller's stream.
//   1. layernorm_kernel (gemm.cuh): t = LN2(x) in bf16, once per row;
//   2. gemm_sm90_kernel (gemm_sm90.cuh) with a bias + QuickGELU epilogue ->
//      g (M, 4C) bf16 [training: the epilogue stores bf16(h) beside g, both
//      from the same f32 accumulators];
//   3. gemm_sm90_kernel with a bias + f32-residual epilogue -> out.
//
// What bounds it on an H100: 2 x 2 x M x C x 4C = 233.7 GFLOP at the flagship
// shape (M = 24,768 rows, C = 768), 0.236 ms at the 989 TFLOP/s bf16 peak;
// the bytes it must move (x, the weights, out; the training form's h, 152 MB)
// take 0.03-0.08 ms: the tensor cores bound it, and the GEMMs run on wgmma fed
// by TMA (gemm_sm90.cuh).  The (M, 4C) hidden g (152 MB at batch 64) and t
// (38 MB), which the TPU kept in VMEM, pass through device memory; keeping g
// on chip (a back-to-back GEMM over 4C in slices) is later work.

#include "gemm_sm90.cuh"

namespace demo2 {
namespace {

// The three launches; h null at eval, else the (rows, hidden) bf16 output.
cudaError_t mlp_block(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, void* t,
                      void* g, void* h, int rows, int width, int hidden, cudaStream_t st) {
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* tb = static_cast<bf16*>(t);
  bf16* gb = static_cast<bf16*>(g);
  const float* b1f = static_cast<const float*>(b1);

  cudaError_t err = launch_layernorm(xb, static_cast<const float*>(ln_scale),
                                     static_cast<const float*>(ln_bias), tb, rows, width, st);
  if (err != cudaSuccess) return err;

  const bf16* w1b = static_cast<const bf16*>(w1);
  err = h == nullptr ? launch_gemm_sm90<BiasQuickGeluEpilogue>(tb, w1b, b1f, gb, nullptr, rows,
                                                               hidden, width, st)
                     : launch_gemm_sm90<BiasQuickGeluHiddenEpilogue>(
                           tb, w1b, b1f, gb, static_cast<bf16*>(h), rows, hidden, width, st);
  if (err != cudaSuccess) return err;

  return launch_gemm_sm90<BiasResidualF32Epilogue>(gb, static_cast<const bf16*>(w2),
                                                   static_cast<const float*>(b2),
                                                   static_cast<bf16*>(out), xb, rows, width,
                                                   hidden, st);
}

}  // namespace
}  // namespace demo2

// Plain C entries, loaded with ctypes.  x and out are (rows, width) bf16, the
// LayerNorm and bias vectors f32, w1 (hidden, width) and w2 (width, hidden)
// bf16 in torch's Linear layout.  t (rows, width) and g (rows, hidden) are
// bf16 scratch.  Each returns the first non-zero cudaGetLastError() of the
// launches, else 0.
extern "C" int demo2_fused_mlp_block(const void* x, const void* ln_scale, const void* ln_bias,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, void* t, void* g, int rows,
                                     int width, int hidden, void* stream) {
  return static_cast<int>(demo2::mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, out, t, g,
                                           nullptr, rows, width, hidden,
                                           static_cast<cudaStream_t>(stream)));
}

// Training: also h (rows, hidden) bf16, the pre-GELU hidden.
extern "C" int demo2_fused_mlp_block_train(const void* x, const void* ln_scale,
                                           const void* ln_bias, const void* w1, const void* b1,
                                           const void* w2, const void* b2, void* out, void* t,
                                           void* g, void* h, int rows, int width, int hidden,
                                           void* stream) {
  return static_cast<int>(demo2::mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, out, t, g, h,
                                           rows, width, hidden,
                                           static_cast<cudaStream_t>(stream)));
}
