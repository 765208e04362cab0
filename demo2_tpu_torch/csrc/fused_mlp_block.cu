// MLP sub-block of the CLIP ViT: out = x + fc2(QuickGELU(fc1(LN2(x)))), at
// eval and, with the pre-GELU hidden as a second output, in training.
//
// Replaces the Pallas kernel demo2_tpu/ops/fused_block.py::_mlp_kernel
// (reached through _fused_mlp_fwd_impl / fused_mlp_block), with its numerics:
//   * LN2 statistics in f32 (centered two-pass variance), t rounded to bf16;
//   * h = t @ W1^T + b1 in f32; g = bf16(h * sigmoid(1.702 h)) from f32 h;
//   * y = g @ W2^T + b2 in f32; out = bf16(f32(x) + y)  (residual in f32).
// The Pallas kernel always writes the pre-GELU h as well, h rounded to bf16
// from the f32 product + bias, which only the training VJP reads
// (fused_block.py::_fused_mlp_bwd).  Here that is the training entry's,
// demo2_fused_mlp_block_train; the eval entry does not write it.
//
// Design: three launches on the caller's stream, all from gemm.cuh:
//   1. layernorm_kernel: t = LN2(x) in bf16, once per row;
//   2. gemm_bf16_kernel with a bias + QuickGELU epilogue -> g (M, 4C) bf16
//      [training: the epilogue stores bf16(h) beside g, both from the same
//      f32 accumulator];
//   3. gemm_bf16_kernel with a bias + f32-residual epilogue -> out.
//
// What bounds it on an H100: 2 x 2 x M x C x 4C = 0.23 TFLOP at the flagship
// shape (M = 24768 rows, C = 768), compute-bound on the tensor cores.  The
// (M, 4C) hidden g (152 MB at batch 64) and t (38 MB), which the TPU kept in
// VMEM, pass through device memory; keeping g on chip (a back-to-back GEMM
// over 4C in slices) is later work.  The training form writes h, another 152
// MB, which is its output and part of its bound.

#include "gemm.cuh"

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
  err = h == nullptr
            ? launch_gemm(tb, w1b, rows, hidden, width, BiasQuickGeluEpilogue{gb, b1f, hidden}, st)
            : launch_gemm(tb, w1b, rows, hidden, width,
                          BiasQuickGeluHiddenEpilogue{gb, static_cast<bf16*>(h), b1f, hidden}, st);
  if (err != cudaSuccess) return err;

  return launch_gemm(gb, static_cast<const bf16*>(w2), rows, width, hidden,
                     BiasResidualF32Epilogue{static_cast<bf16*>(out),
                                             static_cast<const float*>(b2), xb, width},
                     st);
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
