// Attention backward from the saved probabilities, fused with the backward of
// the qkv projection: dqkv never reaches device memory.
//
// Replaces the Pallas kernel demo2_tpu/ops/packed_attention.py::
// _bwd_fused_dw_kernel (reached through _packed_bwd_fused_dw), with its
// numerics: dq, dk, dv as kernel 4 computes them (attention_bwd.cuh,
// Probs::kSaved), rounded to bf16, and only then contracted:
//   dW[j, :]  = sum over the B*S rows of dqkv[row, j] * t[row, :]    (f32)
//   db[j]     = sum over the B*S rows of dqkv[row, j]                (f32)
//   dt[row,:] = bf16(sum over the 3C columns of dqkv[row, j] * W[j, :]),
// the last sum in f32 over the whole 3C, rounded once.  W and dW are in
// torch's Linear layout (3C, C).
//
// The TPU kept a (8 samples x S, 3C) dqkv block in 100 MiB of VMEM and walked
// the batch in order, carrying dW and db from one grid step to the next.  One
// sample's dqkv is 594 KB, an SM has 227 KB, and blocks run in no order, so
// none of that carries over.  Here one head's dq, dk, dv of one sample
// (S16 x 192 bf16, 62 KB) is what stays on chip, and two sums cross blocks:
// dW and db over the samples, dt over the heads.  Both go through f32 partial
// sums that are added in a fixed order, never through atomics, so two runs
// give the same bits:
//
//   * grid (heads, groups); block (h, g) walks the samples g, g + groups, ...
//     in order.  Per sample it runs the attention backward of the head
//     (attention_bwd_head), then from the three bf16 tiles in shared
//     memory
//       - adds their column sums to a register (db of its head, its samples);
//       - writes dqkv_h W_h, the head's share of dt, to dt_partial[h, b]
//         (S16 x C f32; W_h's rows straight from device memory, L2 holds W);
//       - adds dqkv_h^T t_b to dw_partial[g, the head's 192 rows, :], a slice
//         no other block touches, read back and rewritten once per sample
//         (t_b streamed through shared memory 64 columns at a time, rows >= S
//         zero-filled: no row >= S of any input is read).
//   * a second pass adds the `heads` partials of dt in head order and rounds
//     to bf16, and adds the `groups` partials of dW and db in group order.
// A thread-block cluster holding a sample's twelve heads would keep the dt sum
// on chip, but twelve 200 KB blocks need twelve SMs of one GPC at a time; a
// block that loops over a sample's heads cannot hold the S x C f32 dt either
// in registers or in shared memory.  The partial sums are the design that is
// certain to be right; the products are wmma tiles in this kernel's own code.
//
// What bounds it on an H100: at the ViT-B shape (B = 192, S = 129, C = 768) it
// must read qkv, probs, dO, t and W and write dt and dW, ~325 MB, 0.10 ms at
// 3.35 TB/s, and do 8 B H S^2 D + 4 B S C 3C = 1.95e11 operations, 0.20 ms at
// the bf16 peak: operations.  This design also moves its partial sums (1 GB
// of dt_partial written and read, dw_partial through L2), which a redesign
// has to remove before the bound is in reach.

#include "attention_bwd.cuh"

namespace demo2 {
namespace {

constexpr int kSections = 3;               // dq, dk, dv
constexpr int kDwCols = 64;                // columns of t per shared-memory chunk
constexpr int kRowTiles = kMaxSeq / 16;    // at most 9 tiles of 16 sequence rows
static_assert(kDwCols + 8 == kLdH, "a chunk of t has the layout of a head tile");

__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_fused_dw_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ probs,
                              const bf16* __restrict__ dout, const bf16* __restrict__ t,
                              const bf16* __restrict__ w, float* __restrict__ dt_partial,
                              float* __restrict__ dw_partial, float* __restrict__ db_partial,
                              int B, int S, int C, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  // After attention_bwd_head: dq, dk, dv of the head; the V and dO regions
  // are free and take the chunks of t in turns.
  bf16* sec_s[kSections] = {bwd_dq_tile(bwd_smem), reinterpret_cast<bf16*>(bwd_smem),
                            reinterpret_cast<bf16*>(bwd_smem) + kHeadElems};
  bf16* t_s[2] = {reinterpret_cast<bf16*>(bwd_smem) + 2 * kHeadElems,
                  reinterpret_cast<bf16*>(bwd_smem) + 3 * kHeadElems};

  const int h = blockIdx.x;
  const int g = blockIdx.y;
  const int heads = gridDim.x;
  const int groups = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int s_pad = (S + 15) & ~15;
  const int row_tiles = s_pad / 16;
  const HeadLayout packed{static_cast<long long>(S) * 3 * C, kHeadDim, 3 * C};
  const HeadLayout rows{static_cast<long long>(S) * C, kHeadDim, C};
  float* dwp = dw_partial + static_cast<size_t>(g) * 3 * C * C;
  float db_sum = 0.f;  // thread tid < 192: column tid % 64 of section tid / 64

  for (int b = g; b < B; b += groups) {
    attention_bwd_head(bwd_smem, qkv, qkv + C, qkv + 2 * C, packed, dout, rows, probs, S, scale,
                       h, b, heads);

    // db: the column sums of the rounded dq, dk, dv, rows in order.
    if (tid < kSections * kHeadDim) {
      const bf16* col = sec_s[tid / kHeadDim] + (tid % kHeadDim);
      for (int r = 0; r < S; ++r) db_sum += __bfloat162float(col[r * kLdH]);
    }

    // dt_partial[h, b] = dqkv_h (S16 x 192) W_h (192 x C): warp w owns the
    // column tiles w, w + 8, ... and all row tiles of each.
    float* dtp = dt_partial + (static_cast<size_t>(h) * B + b) * s_pad * C;
    for (int nt = warp; nt < C / 16; nt += kBwdWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowTiles];
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt) wmma::fill_fragment(acc[mt], 0.f);
#pragma unroll
      for (int sec = 0; sec < kSections; ++sec) {
        const bf16* w_rows = w + (static_cast<size_t>(sec) * C + h * kHeadDim) * C + nt * 16;
#pragma unroll
        for (int kk = 0; kk < kHeadDim; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, w_rows + static_cast<size_t>(kk) * C, C);
#pragma unroll
          for (int mt = 0; mt < kRowTiles; ++mt) {
            if (mt < row_tiles) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
              wmma::load_matrix_sync(fa, sec_s[sec] + mt * 16 * kLdH + kk, kLdH);
              wmma::mma_sync(acc[mt], fa, fb, acc[mt]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt) {
        if (mt < row_tiles) {
          wmma::store_matrix_sync(dtp + static_cast<size_t>(mt) * 16 * C + nt * 16, acc[mt], C,
                                  wmma::mem_row_major);
        }
      }
    }

    // dw_partial[g, head's rows, :] += dqkv_h^T (192 x S16) t_b (S16 x C), 64
    // columns of t at a time through shared memory, the next chunk loaded
    // while this one is multiplied.  Of the 12 x 4 output tiles of a chunk,
    // warp w owns column tile w % 4 and the row tiles 6 (w / 4) .. + 5.
    const bf16* t_b = t + static_cast<size_t>(b) * S * C;
    auto load_chunk = [&](int j) {
      bf16* dst = t_s[j & 1];
      for (int i = tid; i < s_pad * 8; i += kBwdThreads) {
        const int r = i >> 3;
        const int c = (i & 7) * 8;
        *reinterpret_cast<uint4*>(&dst[r * kLdH + c]) =
            r < S ? *reinterpret_cast<const uint4*>(t_b + static_cast<size_t>(r) * C +
                                                    j * kDwCols + c)
                  : make_uint4(0, 0, 0, 0);
      }
    };
    const bool first = b == g;
    const int ct = warp & 3;
    const int mt0 = (warp >> 2) * 6;
    load_chunk(0);
    __syncthreads();
    for (int j = 0; j < C / kDwCols; ++j) {
      if (j + 1 < C / kDwCols) load_chunk(j + 1);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[6];
      float* tile[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int mt = mt0 + i;  // row tile: section mt / 4, head columns 16 (mt % 4) ..
        tile[i] = dwp +
                  (static_cast<size_t>(mt / 4) * C + h * kHeadDim + (mt % 4) * 16) * C +
                  j * kDwCols + ct * 16;
        if (first) {
          wmma::fill_fragment(acc[i], 0.f);
        } else {
          wmma::load_matrix_sync(acc[i], tile[i], C, wmma::mem_row_major);
        }
      }
      for (int kt = 0; kt < row_tiles; ++kt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, t_s[j & 1] + kt * 16 * kLdH + ct * 16, kLdH);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const int mt = mt0 + i;
          // A^T read col-major from the row-major [s][d] tile.
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::load_matrix_sync(fa, sec_s[mt / 4] + kt * 16 * kLdH + (mt % 4) * 16, kLdH);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        wmma::store_matrix_sync(tile[i], acc[i], C, wmma::mem_row_major);
      }
      __syncthreads();  // chunk j + 1 has landed; chunk j's buffer is free
    }
  }

  if (tid < kSections * kHeadDim) {
    db_partial[static_cast<size_t>(g) * 3 * C + (tid / kHeadDim) * C + h * kHeadDim +
               (tid % kHeadDim)] = db_sum;
  }
}

// dt[b, s, :] = bf16(sum over h of dt_partial[h, b, s, :]), h in order; 8
// values per thread.
__global__ void fused_dw_reduce_dt_kernel(const float* __restrict__ dt_partial,
                                          bf16* __restrict__ dt, int heads, int B, int S,
                                          int C) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int vecs = C / 8;
  if (i >= static_cast<size_t>(B) * S * vecs) return;
  const int c = static_cast<int>(i % vecs) * 8;
  const size_t row = i / vecs;  // b * S + s
  const int s = static_cast<int>(row % S);
  const size_t b = row / S;
  const int s_pad = (S + 15) & ~15;
  float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int h = 0; h < heads; ++h) {
    const float4* p = reinterpret_cast<const float4*>(
        dt_partial + ((static_cast<size_t>(h) * B + b) * s_pad + s) * C + c);
    const float4 lo = p[0], hi = p[1];
    f[0] += lo.x; f[1] += lo.y; f[2] += lo.z; f[3] += lo.w;
    f[4] += hi.x; f[5] += hi.y; f[6] += hi.z; f[7] += hi.w;
  }
  *reinterpret_cast<uint4*>(dt + row * C + c) = pack8(f);
}

// out[i] = sum over g of partial[g, i], g in order.
__global__ void fused_dw_reduce_groups_kernel(const float* __restrict__ partial,
                                              float* __restrict__ out, int groups, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += partial[static_cast<size_t>(g) * n + i];
  out[i] = s;
}

}  // namespace
}  // namespace demo2

// Plain C entry, loaded with ctypes.  qkv (B*S, 3C), probs (B, H, S, S16),
// dout and t (B*S, C) and wqkv (3C, C) are bf16 device pointers; dt (B*S, C)
// bf16, dwqkv (3C, C) and dbqkv (3C,) f32 outputs; dt_partial (H, B, S16, C),
// dw_partial (groups, 3C, C) and db_partial (groups, 3C) f32 scratch, with
// 1 <= groups <= B.  Returns the first non-zero cudaGetLastError() of its
// launches, else 0.
extern "C" int demo2_attention_bwd_fused_dw(const void* qkv, const void* probs,
                                            const void* dout, const void* t, const void* wqkv,
                                            void* dt, void* dwqkv, void* dbqkv,
                                            void* dt_partial, void* dw_partial,
                                            void* db_partial, int batch, int seq, int width,
                                            int heads, int groups, float scale, void* stream) {
  using namespace demo2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_fused_dw_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kBwdSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dtp = static_cast<float*>(dt_partial);
  float* dwp = static_cast<float*>(dw_partial);
  float* dbp = static_cast<float*>(db_partial);
  attention_bwd_fused_dw_kernel<<<dim3(heads, groups), kBwdThreads, kBwdSmemBytes, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(probs),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(t),
      static_cast<const bf16*>(wqkv), dtp, dwp, dbp, batch, seq, width, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dt_vecs = static_cast<size_t>(batch) * seq * (width / 8);
  fused_dw_reduce_dt_kernel<<<static_cast<unsigned>((dt_vecs + 255) / 256), 256, 0, st>>>(
      dtp, static_cast<bf16*>(dt), heads, batch, seq, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dw_n = static_cast<size_t>(3) * width * width;
  fused_dw_reduce_groups_kernel<<<static_cast<unsigned>((dw_n + 255) / 256), 256, 0, st>>>(
      dwp, static_cast<float*>(dwqkv), groups, dw_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t db_n = static_cast<size_t>(3) * width;
  fused_dw_reduce_groups_kernel<<<static_cast<unsigned>((db_n + 255) / 256), 256, 0, st>>>(
      dbp, static_cast<float*>(dbqkv), groups, db_n);
  return static_cast<int>(cudaGetLastError());
}
