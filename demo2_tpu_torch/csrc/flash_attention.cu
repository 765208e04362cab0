// Head-major attention and its backward: attention_core / MultiHeadAttention
// with implementation="pallas", no mask, no active dropout and equal query
// and key lengths (demo2_tpu/ops/attention.py:61-69).
//
// Kernel 9 replaces the Pallas kernel demo2_tpu/ops/flash_attention.py::
// _fwd_kernel (reached through _flash_fwd_impl), kernel 10 ::_bwd_kernel
// (reached through _flash_bwd, the custom VJP's backward, which saves q, k
// and v and recomputes the probabilities).  The TPU kernels cast q, k and v
// to f32 and keep everything in f32 inside: p stays f32 for the PV product,
// and the backward's dV = p^T dO, dS, dQ = dS K and dK = dS^T Q are f32
// (flash_attention.py:58-83); only the outputs are rounded to bf16.  Here:
//   * QK^T on the bf16 q and k with f32 accumulation: the products of bf16
//     values are exact in f32, so this is the f32 product up to the sum
//     order.  The scale multiplies the f32 scores; the Pallas kernel scales
//     q before the product, the same value for the power-of-two scale of
//     64-wide heads;
//   * every product with an f32 operand (p in PV and dV, dS in dQ and dK)
//     runs on the tensor cores as a bf16 hi / lo split of that operand, two
//     products into one f32 accumulator: x = hi + lo leaves at most 2^-18 |x|
//     out, so the products sit within f32 summation noise of an f32 product
//     (checked against an f32 reference in chip_smoke.py);
//   attention_regs_fwd_kernel<Softmax::kF32> and
//   attention_regs_bwd_kernel<Probs::kRecomputeF32> (attention_regs_fwd.cuh,
//   attention_regs_bwd.cuh) hold the design and what bounds it on the card:
//   one warp per 16 rows of a (sample, head), scores, probabilities and dS
//   in registers.  The packed self-attention (packed_attention.cu) runs the
//   other rounding modes of the same two kernels.
//
// Layout: q, k, v, dO and the outputs are (B, S, H, D) bf16, contiguous,
// read through their strides (row stride H*D), so the (B, S, H, D) <->
// (B, H, S, D) copies of the JAX wrapper (jnp.moveaxis) do not exist here.
// Heads of 64 and S <= 144, as packed_attention.cu.

#include "attention_regs_bwd.cuh"
#include "attention_regs_fwd.cuh"

namespace demo2 {
namespace {

inline HeadLayout bshd_layout(int seq, int heads) {
  return HeadLayout{static_cast<long long>(seq) * heads * kHeadDim, kHeadDim, heads * kHeadDim};
}

}  // namespace
}  // namespace demo2

// Plain C entries, loaded with ctypes; every pointer a (B, S, H, 64) bf16
// device tensor.  Each returns cudaGetLastError() of its launch, else 0.
extern "C" int demo2_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int batch, int seq, int heads, float scale, void* stream) {
  using namespace demo2;
  const HeadLayout l = bshd_layout(seq, heads);
  return static_cast<int>(launch_attention_regs_fwd<Softmax::kF32>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), l,
      static_cast<bf16*>(out), l, batch, seq, heads, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" int demo2_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         int batch, int seq, int heads, float scale,
                                         void* stream) {
  using namespace demo2;
  const HeadLayout l = bshd_layout(seq, heads);
  return static_cast<int>(launch_attention_regs_bwd<Probs::kRecomputeF32>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), l,
      static_cast<const bf16*>(dout), l, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), l, batch, seq, heads, scale, static_cast<cudaStream_t>(stream)));
}
