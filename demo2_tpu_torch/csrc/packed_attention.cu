// Packed-qkv self-attention and its backward: every block of the ImageNet
// ViT (demo2_tpu/models/vit.py::ViTAttention) and MultiHeadAttention's
// self-attention with implementation="pallas".
//
// Kernel 5 replaces the Pallas kernel demo2_tpu/ops/packed_attention.py::
// _fwd_kernel (reached through _packed_fwd_impl): qkv (B*S, 3C) bf16 ->
// out (B*S, C) bf16: f32 scores, the row max subtracted, the unnormalised exp
// rounded to bf16 for the PV product, the f32 result divided by
// (rowsum + 1e-30) (packed_attention.py:34-49, :64-72).  It is
// attention_regs_fwd_kernel<Softmax::kNormAfterPV> (attention_regs_fwd.cuh).
//
// Kernel 6 replaces ::_bwd_kernel (reached through _packed_bwd ->
// _packed_bwd_padded), the custom VJP's backward, which saves nothing but
// qkv: p recomputed in f32 from Q and K, dV = bf16(p)^T dO, dS from the f32 p,
// dQ / dK from bf16(dS), dq, dk, dv rounded to bf16 into the packed dqkv
// (packed_attention.py:91-124).  No db: the qkv bias gradient is the column
// sum of dqkv, which the qkv Linear's own backward takes.  It is
// attention_regs_bwd_kernel<Probs::kRecompute> (attention_regs_bwd.cuh).
//
// Those two headers hold the design and what bounds it on the card: each
// head's Q, K, V (and dO) leave device memory once, by one TMA tile copy over
// the packed layout (q, k and v are three tensor maps whose bases lie C
// elements apart, row stride 3C; out and dO have row stride C), and one warp
// carries 16 rows from the loads' arrival to the store with scores,
// probabilities and dS in registers.  The kernels take heads of 64 and
// S <= 144 (demo2_attention_head_dim / _max_seq), which the Python wrapper
// checks.

#include "attention_regs_bwd.cuh"
#include "attention_regs_fwd.cuh"

// Plain C entries, loaded with ctypes.  qkv and dqkv (B*S, 3C), out and dout
// (B*S, C), all bf16 device pointers.  Each returns the error of its launch,
// else 0.
extern "C" int demo2_packed_attention(const void* qkv, void* out, int batch, int seq,
                                      int width, int heads, float scale, void* stream) {
  using namespace demo2;
  const bf16* x = static_cast<const bf16*>(qkv);
  return static_cast<int>(launch_attention_regs_fwd<Softmax::kNormAfterPV>(
      x, x + width, x + 2 * width, packed_layout(seq, width), static_cast<bf16*>(out),
      rows_layout(seq, width), batch, seq, heads, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" int demo2_packed_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                          int batch, int seq, int width, int heads, float scale,
                                          void* stream) {
  using namespace demo2;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* dx = static_cast<bf16*>(dqkv);
  const HeadLayout packed = packed_layout(seq, width);
  return static_cast<int>(launch_attention_regs_bwd<Probs::kRecompute>(
      x, x + width, x + 2 * width, packed, static_cast<const bf16*>(dout),
      rows_layout(seq, width), dx, dx + width, dx + 2 * width, packed, batch, seq, heads, scale,
      static_cast<cudaStream_t>(stream)));
}
