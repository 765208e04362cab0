// What every attention tile shares: the head width and the longest sequence
// the tiles take, the strided head-split layout (HeadLayout) with its two
// packed forms, and the Softmax modes, the points where each Pallas forward
// rounds.  The tiles themselves are attention_regs_fwd.cuh (kernels 1, 3, 5,
// 9 and 13) and attention_regs_bwd.cuh (4, 6, 7 and 10, and 8's attention
// part).
//
// The scores are f32 (bf16 q and k on the tensor cores, f32 accumulation,
// then * scale) and keys >= S are never visited (the Pallas kernels mask them
// to -1e30, whose exp is 0: the same arithmetic).
//
// Layout: a head-split tensor is addressed through HeadLayout, element
// (b, h, s, d) at b * sample + h * head + s * row + d.  The packed qkv
// (B*S, 3C) gives q, k, v as three pointers C apart with row stride 3C; a
// (B, S, H, D) tensor has row stride H*D.  Kernel 3 also writes the
// normalised bf16 p of every (sample, head) to probs (B, H, S, S16), S16 = S
// rounded up to 16, columns >= S zero: the layout of
// demo2_tpu_torch/ops/packed_attention.py that kernels 4, 7 and 8 read.

#pragma once

#include "gemm.cuh"

namespace demo2 {
namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 144;   // keys, padded to 16; ViT-B at 256x128 has 129

// Element (b, h, s, d) of a head-split bf16 tensor at
// b * sample + h * head + s * row + d; row and head are multiples of 8.
struct HeadLayout {
  long long sample;
  int head;
  int row;
  __device__ __forceinline__ size_t at(int b, int h) const {
    return static_cast<size_t>(b) * sample + static_cast<size_t>(h) * head;
  }
};

// Where the forward rounds (all three on attention_regs_fwd.cuh):
//   kNormBeforePV (fused_block.py::_attention_core, kernels 1 and 3):
//       p = exp(s - max) / (sum + 1e-30) in f32, rounded to bf16, then
//       o = bf16(p_bf16 @ v) with f32 accumulation;
//   kNormAfterPV (packed_attention.py::_fwd_kernel; kernels 5 and 13):
//       the UNnormalised exp rounded to bf16 for the PV product, the f32
//       result divided by (sum + 1e-30), where sum adds the unrounded f32 exps;
//   kF32 (flash_attention.py::_fwd_kernel, kernel 9): p stays f32 for the PV
//       product.
enum class Softmax { kNormBeforePV, kNormAfterPV, kF32 };

// The packed qkv (B*S, 3C) as three head-split views, and its (B*S, C)
// counterpart (the attention output, dO).
inline HeadLayout packed_layout(int seq, int width) {
  return HeadLayout{static_cast<long long>(seq) * 3 * width, kHeadDim, 3 * width};
}
inline HeadLayout rows_layout(int seq, int width) {
  return HeadLayout{static_cast<long long>(seq) * width, kHeadDim, width};
}

}  // namespace
}  // namespace demo2
