// The attention ablation tool's kernel: the packed self-attention forward
// with parts of its work left out, to see on the card where the time of the
// attention forward's first design goes (loads, QK^T, softmax, PV): the tiling
// of kernels 1 and 3, and of kernel 5 before it moved to attention_regs_fwd.cuh.
//
// Replaces the Pallas kernel that tools/bench_kernel_ablate.py::make_kernel
// builds, with its cases and their numerics (:32-52).  qkv (B*S, 3C) bf16 ->
// out (B*S, C) bf16; the first `heads` heads are computed, the output columns
// of the others are left as the caller gave them:
//   full         scores * 0.125, keys >= `keys` masked (the tool masks 129 of
//                its 136), the unnormalised exp rounded to bf16 for PV, the
//                f32 result divided by (rowsum + 1e-30): kernel 5's
//                arithmetic, attention_fwd_kernel<Softmax::kNormAfterPV> as it
//                is, with the key count passed in;
//   no_softmax   p = bf16(s * 0.01) on the unscaled, unmasked scores, PV,
//                no division: no max, exp or sums;
//   scores_only  out = bf16(s[:, :64]), the raw scores of the first 64 keys:
//                QK^T over all keys as the tool computes it, no V, no PV;
//   slice_only   out = bf16(bf16(q + k) + v): the loads and the store alone.
// Each case leaves its work out; none computes it and throws it away.
//
// Design: the three reduced cases are attention_ablate_kernel below, which
// keeps attention_fwd_kernel's tiling (one 128-thread block per 16 query rows
// of a head, K then V of the head in shared memory, wmma tiles), so that the
// difference between two cases is the work one of them leaves out.
//
// What bounds it on an H100: every case reads qkv (120 MB at (192, 136,
// 2304)) and writes out (40 MB; a third with 4 heads): 0.048 ms at 3.35 TB/s,
// by bytes; the full case's 4 B S^2 C = 10.9 GFLOP are 0.011 ms at the bf16
// peak.

#include "attention_fwd.cuh"

namespace demo2 {
namespace {

enum class Ablate { kNoSoftmax, kScoresOnly, kSliceOnly };

template <Ablate kMode>
__global__ void __launch_bounds__(kAttnThreads)
attention_ablate_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, HeadLayout in, bf16* __restrict__ out,
                        HeadLayout ol, int S) {
  using namespace nvcuda;
  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t head = in.at(b, h);
  const int r = tid >> 3;          // this thread's row of the tile and
  const int c = (tid & 7) * 8;     // its 8 columns, for loads and the store
  const bool live = q0 + r < S;
  bf16* dst = out + ol.at(b, h) + static_cast<size_t>(q0 + r) * ol.row + c;

  if constexpr (kMode == Ablate::kSliceOnly) {
    if (live) {
      const size_t off = head + static_cast<size_t>(q0 + r) * in.row + c;
      float fq[8], fk[8], fv[8];
      unpack8(*reinterpret_cast<const uint4*>(q + off), fq);
      unpack8(*reinterpret_cast<const uint4*>(k + off), fk);
      unpack8(*reinterpret_cast<const uint4*>(v + off), fv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        fq[i] = __bfloat162float(__float2bfloat16_rn(fq[i] + fk[i])) + fv[i];
      }
      *reinterpret_cast<uint4*>(dst) = pack8(fq);
    }
    return;
  }

  __shared__ __align__(128) bf16 q_s[kQTile * kLdQK];
  __shared__ __align__(128) bf16 kv_s[kMaxSeq * kLdQK];
  __shared__ __align__(128) float s_s[kQTile * kLdS];
  __shared__ __align__(128) bf16 p_s[kQTile * kLdP];
  const int s_pad = (S + 15) & ~15;

  *reinterpret_cast<uint4*>(&q_s[r * kLdQK + c]) =
      live ? *reinterpret_cast<const uint4*>(q + head + static_cast<size_t>(q0 + r) * in.row + c)
           : make_uint4(0, 0, 0, 0);
  auto load_head = [&](const bf16* src) {  // K or V of the head, zero rows past S
    for (int i = tid; i < s_pad * 8; i += kAttnThreads) {
      const int rr = i >> 3;
      const int cc = (i & 7) * 8;
      *reinterpret_cast<uint4*>(&kv_s[rr * kLdQK + cc]) =
          rr < S ? *reinterpret_cast<const uint4*>(src + head + static_cast<size_t>(rr) * in.row +
                                                   cc)
                 : make_uint4(0, 0, 0, 0);
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

  if constexpr (kMode == Ablate::kScoresOnly) {  // the first 64 keys' raw scores (S >= 64)
    if (live) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = s_s[r * kLdS + c + i];
      *reinterpret_cast<uint4*>(dst) = pack8(f);
    }
    return;
  }

  load_head(v);  // V replaces K; the pass below only touches s_s / p_s.
  // p = bf16(s * 0.01): warp w owns query rows 4w .. 4w+3, all S keys.
#pragma unroll
  for (int rr = 0; rr < kQTile / 4; ++rr) {
    const int row = warp * (kQTile / 4) + rr;
    for (int j = lane; j < s_pad; j += 32) {
      p_s[row * kLdP + j] = __float2bfloat16_rn(j < S ? s_s[row * kLdS + j] * 0.01f : 0.f);
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
      wmma::load_matrix_sync(fv, kv_s + kk * kLdQK + warp * 16, kLdQK);
      wmma::load_matrix_sync(fp, p_s + kk, kLdP);
      wmma::mma_sync(acc, fp, fv, acc);
    }
    wmma::store_matrix_sync(s_s + warp * 16, acc, kLdS, wmma::mem_row_major);
  }
  __syncthreads();
  if (live) {
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = s_s[r * kLdS + c + i];
    *reinterpret_cast<uint4*>(dst) = pack8(f);
  }
}

template <Ablate kMode>
cudaError_t launch_ablate(const bf16* x, bf16* out, int batch, int seq, int width, int heads,
                          cudaStream_t st) {
  const dim3 grid((seq + kQTile - 1) / kQTile, heads, batch);
  attention_ablate_kernel<kMode><<<grid, kAttnThreads, 0, st>>>(
      x, x + width, x + 2 * width, packed_layout(seq, width), out, rows_layout(seq, width), seq);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2

// Plain C entry, loaded with ctypes.  qkv (B*S, 3C) and out (B*S, C) are bf16
// device pointers; mode 0 full, 1 no_softmax, 2 scores_only, 3 slice_only;
// `keys` <= seq the valid keys of the full case; `heads` <= width / 64 the
// heads computed.  Returns cudaGetLastError() of its launch, else 0; -1 for an
// unknown mode.
extern "C" int demo2_attention_ablate(const void* qkv, void* out, int batch, int seq, int width,
                                      int heads, int mode, int keys, void* stream) {
  using namespace demo2;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return static_cast<int>(launch_attention_fwd<Softmax::kNormAfterPV, false>(
          x, x + width, x + 2 * width, packed_layout(seq, width), o, rows_layout(seq, width),
          nullptr, batch, seq, heads, 0.125f, st, keys));
    case 1:
      return static_cast<int>(launch_ablate<Ablate::kNoSoftmax>(x, o, batch, seq, width, heads, st));
    case 2:
      return static_cast<int>(launch_ablate<Ablate::kScoresOnly>(x, o, batch, seq, width, heads, st));
    case 3:
      return static_cast<int>(launch_ablate<Ablate::kSliceOnly>(x, o, batch, seq, width, heads, st));
    default:
      return -1;
  }
}
