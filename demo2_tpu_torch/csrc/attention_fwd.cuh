// The first design of the attention forward tile: the attention part of the
// block kernels (fused_attention_block.cu: kernels 1 and 3).  The packed
// self-attention (5), the head-major attention (9) and the ablation tool (13)
// run on attention_regs_fwd.cuh.  Each Pallas kernel rounds at another point:
// the Softmax mode, a template parameter of both designs, listed at the enum
// below; this file carries Softmax::kNormBeforePV alone.
//
// The scores are f32 (bf16 q and k on the tensor cores, f32 accumulation,
// then * scale) and keys >= S are never visited (the Pallas kernels mask them
// to -1e30, whose exp is 0: the same arithmetic).
//
// Layout: a head-split tensor is addressed through HeadLayout, element
// (b, h, s, d) at b * sample + h * head + s * row + d.  The packed qkv
// (B*S, 3C) gives q, k, v as three pointers C apart with row stride 3C; a
// (B, S, H, D) tensor has row stride H*D.  With kSaveProbs the normalised
// bf16 p of every (sample, head) also goes to probs (B, H, S, S16), S16 = S
// rounded up to 16, columns >= S zero: the layout of
// demo2_tpu_torch/ops/packed_attention.py that attention_bwd.cuh reads.
//
// Design: one 128-thread block per (query tile of 16 rows, head, sample).
// The head's K, then V, sit in shared memory (<= 144 x 64 bf16 = 18 KB at a
// time), the 16 x S_pad f32 score tile beside them; QK^T and PV run on the
// tensor cores (wmma), the softmax on CUDA cores, one warp per 4 query rows.
// At the ViT-B shape (B = 192, S = 129, 12 heads of 64) attention is ~10
// GFLOP on 33 KB of K/V per (sample, head) and is bound by the shared-memory
// traffic of the simple wmma tiles, not by device memory.  Split by the
// ablation tool while it still ran on this tiling (H100, qkv (192, 136, 2304),
// 0.3205 ms in all): loads and store 0.0756, QK^T 0.0627, PV 0.1038, softmax
// 0.0784 ms, one after another with block barriers between.

#pragma once

#include <mma.h>

#include "gemm.cuh"

namespace demo2 {
namespace {

constexpr int kHeadDim = 64;
constexpr int kQTile = 16;     // query rows per block (one wmma tile)
constexpr int kMaxSeq = 144;   // keys, padded to 16; ViT-B at 256x128 has 129
constexpr int kLdQK = kHeadDim + 8;
constexpr int kLdS = kMaxSeq + 4;
constexpr int kLdP = kMaxSeq + 8;
constexpr int kAttnThreads = 128;

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

// Where the forward rounds, and which header instantiates the mode:
//   kNormBeforePV (fused_block.py::_attention_core, kernels 1 and 3; this
//       file): p = exp(s - max) / (sum + 1e-30) in f32, rounded to bf16, then
//       o = bf16(p_bf16 @ v) with f32 accumulation;
//   kNormAfterPV (packed_attention.py::_fwd_kernel; kernels 5 and 13,
//       attention_regs_fwd.cuh only):
//       the UNnormalised exp rounded to bf16 for the PV product, the f32
//       result divided by (sum + 1e-30), where sum adds the unrounded f32 exps;
//   kF32 (flash_attention.py::_fwd_kernel, kernel 9; attention_regs_fwd.cuh
//       only): p stays f32 for the PV product.
enum class Softmax { kNormBeforePV, kNormAfterPV, kF32 };

template <Softmax kMode, bool kSaveProbs>
__global__ void __launch_bounds__(kAttnThreads)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, HeadLayout in, bf16* __restrict__ out,
                     HeadLayout ol, bf16* __restrict__ probs, int S, float scale) {
  using namespace nvcuda;
  static_assert(kMode == Softmax::kNormBeforePV, "the other modes: attention_regs_fwd.cuh");
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
  const size_t head = in.at(b, h);

  // Q tile: 16 rows x 8 vectors of 8 = one vector per thread.
  {
    const int r = tid >> 3;
    const int c = (tid & 7) * 8;
    const uint4 val = (q0 + r < S)
                          ? *reinterpret_cast<const uint4*>(q + head + (q0 + r) * in.row + c)
                          : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(&q_s[r * kLdQK + c]) = val;
  }
  auto load_head = [&](const bf16* src) {  // K or V of the head, zero rows past S
    for (int i = tid; i < s_pad * 8; i += kAttnThreads) {
      const int r = i >> 3;
      const int c = (i & 7) * 8;
      const uint4 val = (r < S) ? *reinterpret_cast<const uint4*>(src + head + r * in.row + c)
                                : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&kv_s[r * kLdQK + c]) = val;
    }
  };
  load_head(k);
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

  load_head(v);  // V replaces K; the softmax below only touches s_s / p_s.

  // Softmax: warp w owns query rows 4w .. 4w+3.
#pragma unroll
  for (int rr = 0; rr < kQTile / 4; ++rr) {
    const int r = warp * (kQTile / 4) + rr;
    float* srow = s_s + r * kLdS;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float val = srow[j] * scale;
      srow[j] = val;
      m = fmaxf(m, val);
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

  if (kSaveProbs) {  // the tile's rows < S, all S16 columns, 16-byte vectors
    const int vecs = s_pad / 8;
    bf16* dst = probs + ((static_cast<size_t>(b) * gridDim.y + h) * S + q0) * s_pad;
    for (int i = tid; i < kQTile * vecs; i += kAttnThreads) {
      const int r = i / vecs;
      const int c = (i - r * vecs) * 8;
      if (q0 + r < S) {
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * s_pad + c) =
            *reinterpret_cast<const uint4*>(&p_s[r * kLdP + c]);
      }
    }
  }

  // O = P V: warp w owns output columns 16w .. 16w+15; staged through s_s.
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < s_pad; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
      wmma::load_matrix_sync(fv, kv_s + kk * kLdQK + warp * 16, kLdQK);
      wmma::load_matrix_sync(fp, p_s + kk, kLdP);
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
      *reinterpret_cast<uint4*>(out + ol.at(b, h) + static_cast<size_t>(q0 + r) * ol.row + c) =
          pack8(f);
    }
  }
}

template <Softmax kMode, bool kSaveProbs>
cudaError_t launch_attention_fwd(const bf16* q, const bf16* k, const bf16* v, HeadLayout in,
                                 bf16* out, HeadLayout ol, bf16* probs, int batch, int seq,
                                 int heads, float scale, cudaStream_t st) {
  const dim3 grid((seq + kQTile - 1) / kQTile, heads, batch);
  attention_fwd_kernel<kMode, kSaveProbs><<<grid, kAttnThreads, 0, st>>>(
      q, k, v, in, out, ol, probs, seq, scale);
  return cudaGetLastError();
}

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
