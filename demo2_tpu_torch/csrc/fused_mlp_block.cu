// MLP sub-block of the CLIP ViT at eval: out = x + fc2(QuickGELU(fc1(LN2(x)))).
//
// Replaces the Pallas kernel demo2_tpu/ops/fused_block.py::_mlp_kernel
// (reached through _fused_mlp_fwd_impl / fused_mlp_block), with its numerics:
//   * LN2 statistics in f32 (centered two-pass variance), t rounded to bf16;
//   * h = t @ W1^T + b1 in f32; g = bf16(h * sigmoid(1.702 h)) from f32 h;
//   * y = g @ W2^T + b2 in f32; out = bf16(f32(x) + y)  (residual in f32).
// The Pallas kernel also writes the pre-GELU h, which only the training VJP
// reads (fused_block.py::_fused_mlp_bwd); this eval kernel does not.
//
// Design: three launches on the caller's stream, all from gemm.cuh:
//   1. layernorm_kernel: t = LN2(x) in bf16, once per row;
//   2. gemm_bf16_kernel with a bias + QuickGELU epilogue -> g (M, 4C) bf16;
//   3. gemm_bf16_kernel with a bias + f32-residual epilogue -> out.
//
// What bounds it on an H100: 2 x 2 x M x C x 4C = 0.23 TFLOP at the flagship
// shape (M = 24768 rows, C = 768), compute-bound on the tensor cores.  The
// (M, 4C) hidden g (152 MB at batch 64) and t (38 MB), which the TPU kept in
// VMEM, pass through device memory; keeping g on chip (a back-to-back GEMM
// over 4C in slices) is later work.

#include "gemm.cuh"

// Plain C entry, loaded with ctypes.  x and out are (rows, width) bf16, the
// LayerNorm and bias vectors f32, w1 (hidden, width) and w2 (width, hidden)
// bf16 in torch's Linear layout.  t (rows, width) and g (rows, hidden) are
// bf16 scratch.  Returns the first non-zero
// cudaGetLastError() of the launches, else 0.
extern "C" int demo2_fused_mlp_block(const void* x, const void* ln_scale, const void* ln_bias,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, void* out, void* t, void* g, int rows,
                                     int width, int hidden, void* stream) {
  using namespace demo2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* tb = static_cast<bf16*>(t);
  bf16* gb = static_cast<bf16*>(g);

  cudaError_t err = launch_layernorm(xb, static_cast<const float*>(ln_scale),
                                     static_cast<const float*>(ln_bias), tb, rows, width, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_gemm(tb, static_cast<const bf16*>(w1), rows, hidden, width,
                    BiasQuickGeluEpilogue{gb, static_cast<const float*>(b1), hidden}, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_gemm(gb, static_cast<const bf16*>(w2), rows, width, hidden,
                    BiasResidualF32Epilogue{static_cast<bf16*>(out),
                                            static_cast<const float*>(b2), xb, width},
                    st);
  return static_cast<int>(err);
}
