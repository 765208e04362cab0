// Attention sub-block of the CLIP ViT: out = x + out_proj(MHA(LN1(x))), at
// eval and, with its training residuals, in training.
//
// Replaces the Pallas kernels demo2_tpu/ops/fused_block.py::_fwd_kernel_infer
// (eval, kernel 1, reached through _fused_infer_impl) and ::_fwd_kernel
// (training, kernel 3, reached through _fused_fwd_impl), with their numerics:
//   * LN1 statistics in f32 (centered two-pass variance), t rounded to bf16;
//   * qkv = bf16(t @ Wqkv^T + bqkv) with f32 accumulation and f32 bias;
//   * scores in f32, keys >= S masked (here: never visited), softmax in f32
//     with +1e-30 in the denominator, p normalised then rounded to bf16;
//   * attn = bf16(p @ v) with f32 accumulation;
//   * y = bf16(attn @ Wout^T + bout); out = bf16(x + y)  (residual in bf16).
// The training entry also keeps qkv and attn (which the eval entry writes as
// scratch) and stores the bf16 p of every (sample, head) in the probs layout
// of demo2_tpu_torch/ops/packed_attention.py: (B, H, S, S16), S16 = S rounded
// up to 16, columns >= S zero.  That is the layout kernel 4 reads.  Kernel 1
// is kernel 3 without those stores.
//
// Design: four launches on the caller's stream.
//   1. layernorm_kernel (gemm.cuh): t = LN1(x) in bf16, once per row;
//   2. gemm_sm90_kernel (gemm_sm90.cuh) with a bias epilogue -> qkv (M, 3C);
//   3. attention_regs_fwd_kernel<Softmax::kNormBeforePV> (attention_regs_fwd.cuh)
//      on the packed qkv, kernel 5's tile and task stream in kernel 1's
//      rounding mode; kernel 3's form also stores the probabilities.  Past
//      the register tiles' 144 tokens (up to 256: the flagship at stride 12,
//      211 tokens) the _wide entries run block_wide_fwd_kernel
//      (attention_wide_block.cuh) in its place, the same arithmetic on the
//      wide pair's operand ring;
//   4. gemm_sm90_kernel with a bias + bf16-residual epilogue -> out.
//
// What bounds it on an H100: at the flagship shape (M = 192 x 129 rows,
// C = 768, 12 heads of 64) the two projections are 116.9 GFLOP and attention
// 9.8, 0.128 ms at the 989 TFLOP/s bf16 peak; what must move, x, the weights
// and out (and for kernel 3 qkv, attn and the 85.6 MB of probs), takes less:
// operations bound it.  The GEMMs run on wgmma fed by TMA (gemm_sm90.cuh), the
// attention with scores and probabilities in registers
// (attention_regs_fwd.cuh).  What the TPU kept in VMEM, t and attn (38 MB
// each) and qkv (114 MB), pass through device memory here: four launches
// rather than one.

#include "attention_regs_fwd.cuh"
#include "attention_wide_block.cuh"
#include "gemm_sm90.cuh"

namespace demo2 {
namespace {

// The four launches; probs == nullptr is the eval path (no probs store).
// `wide`: launch 3 on block_wide_fwd_kernel (1 <= S <= 256), else on the
// register tiles (S <= kMaxSeq).
cudaError_t attention_block(const bf16* x, const float* ln_scale, const float* ln_bias,
                            const bf16* wqkv, const float* bqkv, const bf16* wout,
                            const float* bout, bf16* out, bf16* t, bf16* qkv, bf16* attn,
                            bf16* probs, int batch, int seq, int width, int heads, float scale,
                            bool wide, cudaStream_t st) {
  if (width != heads * kHeadDim || seq > (wide ? kWideMaxSeq : kMaxSeq)) {
    return cudaErrorInvalidValue;
  }
  const int rows = batch * seq;
  cudaError_t err = launch_layernorm(x, ln_scale, ln_bias, t, rows, width, st);
  if (err != cudaSuccess) return err;

  err = launch_gemm_sm90<BiasEpilogue>(t, wqkv, bqkv, qkv, nullptr, rows, 3 * width, width, st);
  if (err != cudaSuccess) return err;

  const HeadLayout in = packed_layout(seq, width), ol = rows_layout(seq, width);
  if (wide) {
    err = probs != nullptr ? launch_block_wide_fwd<true>(qkv, attn, probs, batch, seq, width,
                                                         heads, scale, st)
                           : launch_block_wide_fwd<false>(qkv, attn, nullptr, batch, seq,
                                                          width, heads, scale, st);
  } else {
    err = probs != nullptr
              ? launch_attention_regs_fwd<Softmax::kNormBeforePV, Ablate::kNone, true>(
                    qkv, qkv + width, qkv + 2 * width, in, attn, ol, batch, seq, heads, scale,
                    st, seq, probs)
              : launch_attention_regs_fwd<Softmax::kNormBeforePV>(
                    qkv, qkv + width, qkv + 2 * width, in, attn, ol, batch, seq, heads, scale,
                    st);
  }
  if (err != cudaSuccess) return err;

  return launch_gemm_sm90<BiasResidualBf16Epilogue>(attn, wout, bout, out, x, rows, width, width,
                                                    st);
}

}  // namespace
}  // namespace demo2

// Plain C entries, loaded with ctypes.  Pointers are device pointers; x, out,
// qkv and attn are row-major bf16, the LayerNorm and bias vectors f32, the
// weights bf16 in torch's Linear layout (out, in).  t and attn are (B*S, C)
// and qkv (B*S, 3C) bf16.  Each returns the first non-zero cudaGetLastError()
// of its launches, else 0.  The _wide entries take heads of 64 over
// 1 <= S <= 256 (demo2_block_attention_max_seq), the others S <= 144.
#define DEMO2_BLOCK_ARGS(probs, wide)                                                         \
  static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),                           \
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(wqkv),                     \
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wout),                        \
      static_cast<const float*>(bout), static_cast<bf16*>(out), static_cast<bf16*>(t),        \
      static_cast<bf16*>(qkv), static_cast<bf16*>(attn), probs, batch, seq, width, heads,     \
      scale, wide, static_cast<cudaStream_t>(stream)

// Eval (kernel 1): t, qkv and attn are scratch.
extern "C" int demo2_fused_attention_block(const void* x, const void* ln_scale,
                                           const void* ln_bias, const void* wqkv,
                                           const void* bqkv, const void* wout,
                                           const void* bout, void* out, void* t, void* qkv,
                                           void* attn, int batch, int seq, int width, int heads,
                                           float scale, void* stream) {
  using namespace demo2;
  return static_cast<int>(attention_block(DEMO2_BLOCK_ARGS(nullptr, false)));
}

extern "C" int demo2_fused_attention_block_wide(const void* x, const void* ln_scale,
                                                const void* ln_bias, const void* wqkv,
                                                const void* bqkv, const void* wout,
                                                const void* bout, void* out, void* t, void* qkv,
                                                void* attn, int batch, int seq, int width,
                                                int heads, float scale, void* stream) {
  using namespace demo2;
  return static_cast<int>(attention_block(DEMO2_BLOCK_ARGS(nullptr, true)));
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
  return static_cast<int>(attention_block(DEMO2_BLOCK_ARGS(static_cast<bf16*>(probs), false)));
}

extern "C" int demo2_fused_attention_block_train_wide(const void* x, const void* ln_scale,
                                                      const void* ln_bias, const void* wqkv,
                                                      const void* bqkv, const void* wout,
                                                      const void* bout, void* out, void* t,
                                                      void* qkv, void* attn, void* probs,
                                                      int batch, int seq, int width, int heads,
                                                      float scale, void* stream) {
  using namespace demo2;
  return static_cast<int>(attention_block(DEMO2_BLOCK_ARGS(static_cast<bf16*>(probs), true)));
}

// Compile-time limits of every attention tile (kernels 1, 3-10, 13),
// which the Python wrappers check before launching, and the longest sequence
// of the block kernels' wide forms (kernels 1, 3, 4, 7 and 8).
extern "C" int demo2_attention_head_dim() { return demo2::kHeadDim; }
extern "C" int demo2_attention_max_seq() { return demo2::kMaxSeq; }
extern "C" int demo2_block_attention_max_seq() { return demo2::kWideMaxSeq; }

extern "C" const char* demo2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
