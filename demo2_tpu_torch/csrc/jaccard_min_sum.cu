// The Jaccard numerator of k-reciprocal re-ranking:
//   out[i, j] = sum over k of min(vq[i, k], vg[j, k]),  f32 in and out,
//   vq (nq, depth), vg (ng, depth), out (nq, ng), any sizes.
//
// Replaces the Pallas kernel demo2_tpu/utils/reranking.py::_jaccard_kernel
// (reached through _jaccard_min_sum from re_ranking_device).  It computes the
// dense sum, as the TPU kernel does; the sparsity of the re-ranking weights
// is not used.
//
// What bounds it on the card: operations.  The work has the shape of a matrix
// product with (min, +) in place of (x, +): 2 nq ng depth f32 operations (7.4e10
// at nq = 1,600, ng = depth = 4,800) against nq depth + ng depth + nq ng values
// of traffic (154 MB).  min and add do not fuse into one instruction as a
// multiply-add does, and the tensor cores have no such product, so the CUDA
// cores' instruction rate is the limit.  The design is therefore the register-tiled
// SGEMM: a 128 x 128 output tile per 256-thread block, walked along depth in
// 16-wide slices held transposed in shared memory, each thread an 8 x 8
// register tile (two 4-wide strips per side, so a warp's shared-memory reads
// are 16-byte vectors without bank conflicts), 16 shared-memory values read
// for 128 operations.  The next slice is loaded from device memory into
// registers while the current one is computed.  The TPU kernel's (64, 256)
// tiles and its per-row loop are VMEM choices and are not carried over.
//
// Each output is one thread's f32 sum over k in ascending order: the same
// bits on every run.  Edges are handled by zero fill on load (min(0, 0) adds
// nothing) and a bounds check on store; depth that is no multiple of 4, or
// rows that are not 16-byte aligned, load value by value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace demo2 {
namespace {

constexpr int kJcTile = 128;     // output tile, both sides
constexpr int kJcDepth = 16;     // depth slice
constexpr int kJcThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kJcPad = 4;        // keeps rows 16-byte aligned, spreads the banks
constexpr int kJcLoads = kJcTile * kJcDepth / 4 / kJcThreads;  // float4 loads per side: 2

// The 4 values of row `row` at depth k .. k + 3 (zero outside the matrix).
template <bool kVector>
__device__ __forceinline__ float4 load4(const float* __restrict__ m, int rows, int depth,
                                        int row, int k) {
  if (row >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = m + static_cast<size_t>(row) * depth + k;
  if (kVector) {
    if (k < depth) return *reinterpret_cast<const float4*>(p);  // depth % 4 == 0
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 v;
  v.x = k < depth ? p[0] : 0.f;
  v.y = k + 1 < depth ? p[1] : 0.f;
  v.z = k + 2 < depth ? p[2] : 0.f;
  v.w = k + 3 < depth ? p[3] : 0.f;
  return v;
}

// Load slot l of a thread: row (tid + l * 256) / 4 of the tile, the 4 values
// at depth offset ((tid + l * 256) % 4) * 4 of the slice.
template <bool kVector>
__device__ __forceinline__ void fetch_slice(const float* __restrict__ m, int rows, int depth,
                                            int row0, int k0, int tid,
                                            float4 (&reg)[kJcLoads]) {
#pragma unroll
  for (int l = 0; l < kJcLoads; ++l) {
    const int slot = tid + l * kJcThreads;
    reg[l] = load4<kVector>(m, rows, depth, row0 + (slot >> 2), k0 + (slot & 3) * 4);
  }
}

// The loaded slice into shared memory, transposed to [depth][row].
__device__ __forceinline__ void stage_slice(float (&tile)[kJcDepth][kJcTile + kJcPad], int tid,
                                            const float4 (&reg)[kJcLoads]) {
#pragma unroll
  for (int l = 0; l < kJcLoads; ++l) {
    const int slot = tid + l * kJcThreads;
    const int row = slot >> 2, kq = (slot & 3) * 4;
    tile[kq + 0][row] = reg[l].x;
    tile[kq + 1][row] = reg[l].y;
    tile[kq + 2][row] = reg[l].z;
    tile[kq + 3][row] = reg[l].w;
  }
}

// Two blocks to an SM (at most 128 registers a thread): 16 warps to hide the
// shared-memory reads behind the sums.
template <bool kVector>
__global__ void __launch_bounds__(kJcThreads, 2)
jaccard_min_sum_kernel(const float* __restrict__ vq, const float* __restrict__ vg,
                       float* __restrict__ out, int nq, int ng, int depth) {
  __shared__ __align__(16) float qs[kJcDepth][kJcTile + kJcPad];
  __shared__ __align__(16) float gs[kJcDepth][kJcTile + kJcPad];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * kJcTile, j0 = blockIdx.x * kJcTile;

  float4 qreg[kJcLoads], greg[kJcLoads];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  fetch_slice<kVector>(vq, nq, depth, i0, 0, tid, qreg);
  fetch_slice<kVector>(vg, ng, depth, j0, 0, tid, greg);
  for (int k0 = 0; k0 < depth; k0 += kJcDepth) {
    stage_slice(qs, tid, qreg);
    stage_slice(gs, tid, greg);
    __syncthreads();
    if (k0 + kJcDepth < depth) {  // the next slice's loads fly during this one's sums
      fetch_slice<kVector>(vq, nq, depth, i0, k0 + kJcDepth, tid, qreg);
      fetch_slice<kVector>(vg, ng, depth, j0, k0 + kJcDepth, tid, greg);
    }
#pragma unroll
    for (int kk = 0; kk < kJcDepth; ++kk) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[kk][ty * 4]);
      const float4 qb = *reinterpret_cast<const float4*>(&qs[kk][64 + ty * 4]);
      const float4 ga = *reinterpret_cast<const float4*>(&gs[kk][tx * 4]);
      const float4 gb = *reinterpret_cast<const float4*>(&gs[kk][64 + tx * 4]);
      const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += fminf(q[i], g[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= nq) continue;
    float* dst = out + static_cast<size_t>(row) * ng;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < ng) dst[col] = acc[i][j];
    }
  }
}

}  // namespace
}  // namespace demo2

// Plain C entry, loaded with ctypes.  vq (nq, depth), vg (ng, depth) and out
// (nq, ng) are f32 device pointers.  Returns cudaGetLastError() of the launch.
extern "C" int demo2_jaccard_min_sum(const void* vq, const void* vg, void* out, int nq, int ng,
                                     int depth, void* stream) {
  using namespace demo2;
  if (nq < 1 || ng < 1 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(vq);
  const float* g = static_cast<const float*>(vg);
  float* o = static_cast<float*>(out);
  const dim3 grid((ng + kJcTile - 1) / kJcTile, (nq + kJcTile - 1) / kJcTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vector = depth % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (vector) {
    jaccard_min_sum_kernel<true><<<grid, kJcThreads, 0, st>>>(q, g, o, nq, ng, depth);
  } else {
    jaccard_min_sum_kernel<false><<<grid, kJcThreads, 0, st>>>(q, g, o, nq, ng, depth);
  }
  return static_cast<int>(cudaGetLastError());
}
