// The Jaccard numerator of k-reciprocal re-ranking:
//   out[i, j] = sum over k of min(vq[i, k], vg[j, k]),  f32 in and out,
//   vq (nq, depth), vg (ng, depth), out (nq, ng), any sizes.
//
// Replaces the Pallas kernel demo2_tpu/utils/reranking.py::_jaccard_kernel
// (reached through _jaccard_min_sum from re_ranking_device), which sums
// densely.  Here the sum runs over the non-zeros of the operands only: the
// re-ranking weights V are exp(-dist) under the expanded k-reciprocal mask,
// row-normalised and averaged over k2 rows, so they are non-negative and, at
// k1 = 50 among 4,800 samples, about 5% non-zero.
//
// The bits.  Each output is one lane's f32 sum in ascending k from +0.0, as
// a dense ascending loop gives it (jaccard_min_sum_ordered).  For
// non-negative inputs a k where either operand is zero adds min(.) = +0.0
// (or -0.0), and adding a zero to an f32 partial sum that starts at +0.0
// changes no bit.  So the sum over the k where both operands are non-zero,
// taken in ascending k, equals the dense ascending sum bit for bit, and
// reruns give the same bits: nothing is reassociated, split across lanes or
// fused (min and add are separate instructions).  A negative or NaN input
// breaks that argument: the compaction flags it, and the accumulation then
// takes the dense form, every k in ascending order, with the same bits.
//
// The design is the row-by-row (Gustavson) form of a sparse product with
// (min, +) in place of (x, +), in three launches:
//   1. compact_rows: the non-zeros of each row of vq, in ascending k, as
//      (k, value) pairs in a slot of depth entries per row;
//   2. compact_columns: the non-zeros of each column of vg within each tile
//      of kTile gallery rows, in ascending j, as (j - tile start, value)
//      pairs in a slot of kTile entries per (tile, k); a block reads 32-row
//      x 32-column patches of vg coalesced, through shared memory;
//   3. accumulate: one warp per (gallery tile, query row), tile-major.  The
//      warp keeps the row's kTile f32 accumulators in shared memory, walks
//      the row's non-zero k in ascending order and, for each, adds min(vq[i,
//      k], vg[j, k]) into accumulator j for each non-zero j of column k in
//      its tile, the lanes taking distinct j (no atomics), with a __syncwarp
//      between two k so that every accumulator takes its terms in order.
//      The first 32 pairs of the next kRing k are in flight in registers
//      while this k's are added.  Then the warp writes the whole dense tile
//      of the output row.
// Slots of fixed size need no count pass and no read by the host; the
// wrapper allocates them as one torch.empty.
//
// What bounds it on the card: bytes.  Reading vq and vg once and writing out
// moves (nq + ng) depth + nq ng f32 values: 154 MB, 0.046 ms at 3.35 TB/s, at
// nq = 1,600, ng = depth = 4,800.  The work is two operations for each (i, j,
// k) with both operands non-zero: about 2e8 at 5% density, nothing against
// the card's rate.  (The dense sum's 7.4e10 operations would take 1.1 ms at
// the 67 TFLOP/s of f32.)  What the design pays instead is the pairs it
// reads again: each column list once for every query row that needs it, from
// L2, 8 bytes a pair (~0.8 GB at that size, with shared-memory adds whose
// banks collide at random).  At full density that is the dense work done
// through shared memory, ten times slower than a register-tiled dense
// product: right at every density, fast at the sparse ones re-ranking gives.

#include <cuda_runtime.h>
#include <stdint.h>

namespace demo2 {
namespace {

constexpr int kTile = 1024;   // gallery rows a warp accumulates: 4 KB of shared memory
constexpr int kWarps = 8;     // warps a block
constexpr int kRing = 8;      // steps whose pairs a warp has in flight
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool bad_value(float v) { return !(v >= 0.f); }  // negative or NaN

// The non-zeros of row `row` of vq in ascending k: pairs (k, bits of the
// value) at qlist[row * depth ...], their number at qcnt[row].  One warp a
// row, kUnroll coalesced loads in flight a lane.
__global__ void __launch_bounds__(kWarps * 32)
compact_rows(const float* __restrict__ vq, int2* __restrict__ qlist, int* __restrict__ qcnt,
             int* __restrict__ flag, int nq, int depth) {
  constexpr int kUnroll = 16;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= nq) return;
  const float* src = vq + static_cast<size_t>(row) * depth;
  int2* dst = qlist + static_cast<size_t>(row) * depth;
  int count = 0;
  bool bad = false;
  for (int k0 = 0; k0 < depth; k0 += 32 * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + 32 * u + lane;
      v[u] = k < depth ? src[k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + 32 * u + lane;
      bad |= k < depth && bad_value(v[u]);
      const bool nz = v[u] != 0.f;
      const unsigned mask = __ballot_sync(kAll, nz);
      if (nz) {
        dst[count + __popc(mask & ((1u << lane) - 1u))] = make_int2(k, __float_as_int(v[u]));
      }
      count += __popc(mask);
    }
  }
  if (__any_sync(kAll, bad) && lane == 0) *flag = 1;
  if (lane == 0) qcnt[row] = count;
}

// The non-zeros of column k of vg within gallery tile t, in ascending j:
// pairs (j - t kTile, bits of the value) at glist[(t depth + k) kTile ...],
// their number at gcnt[t depth + k].  A block takes 32 columns of one tile;
// each warp compacts 4 of them, 32 rows at a time.
__global__ void __launch_bounds__(kWarps * 32)
compact_columns(const float* __restrict__ vg, int2* __restrict__ glist, int* __restrict__ gcnt,
                int* __restrict__ flag, int ng, int depth) {
  constexpr int kCols = 32 / kWarps;
  __shared__ float patch[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * 32, t = blockIdx.y;
  const int j_end = min(kTile, ng - t * kTile);
  int count[kCols] = {};
  bool bad = false;
  for (int jj0 = 0; jj0 < j_end; jj0 += 32) {
#pragma unroll
    for (int r = warp; r < 32; r += kWarps) {  // row jj0 + r, column k0 + lane
      const int jj = jj0 + r, k = k0 + lane;
      const bool in = jj < j_end && k < depth;
      const float v = in ? vg[static_cast<size_t>(t * kTile + jj) * depth + k] : 0.f;
      bad |= in && bad_value(v);
      patch[r][lane] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = warp * kCols + c, k = k0 + col;
      const float v = patch[lane][col];  // row jj0 + lane
      const bool nz = v != 0.f;
      const unsigned mask = __ballot_sync(kAll, nz);
      if (nz && k < depth) {
        int2* dst = glist + (static_cast<size_t>(t) * depth + k) * kTile;
        dst[count[c] + __popc(mask & ((1u << lane) - 1u))] =
            make_int2(jj0 + lane, __float_as_int(v));
      }
      count[c] += __popc(mask);
    }
    __syncthreads();
  }
  if (__any_sync(kAll, bad) && lane == 0) *flag = 1;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int k = k0 + warp * kCols + c;
    if (lane == 0 && k < depth) gcnt[static_cast<size_t>(t) * depth + k] = count[c];
  }
}

// The dense form for inputs the compaction flagged (negative or NaN): out[i,
// j] as one lane's ascending-k sum over every k, min propagating NaN as
// torch.minimum does.  Each lane reads its own row of vg: slow, but right.
__device__ void dense_tile(const float* __restrict__ vq, const float* __restrict__ vg,
                           float* __restrict__ dst, int i, int j0, int j_end, int depth,
                           int lane) {
  const float* q = vq + static_cast<size_t>(i) * depth;
  for (int jj = lane; jj < j_end; jj += 32) {
    const float* g = vg + static_cast<size_t>(j0 + jj) * depth;
    float acc = 0.f;
    for (int k = 0; k < depth; ++k) {
      const float a = q[k], b = g[k];
      acc += (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
    }
    dst[jj] = acc;
  }
}

// One warp per (tile t, query row i), t-major: out[i, t kTile + jj] for jj
// in the tile, each an ascending-k sum over the k where both vq[i, k] and
// vg[t kTile + jj, k] are non-zero.
__global__ void __launch_bounds__(kWarps * 32)
accumulate(const float* __restrict__ vq, const float* __restrict__ vg,
           const int2* __restrict__ qlist, const int* __restrict__ qcnt,
           const int2* __restrict__ glist, const int* __restrict__ gcnt,
           const int* __restrict__ flag, float* __restrict__ out, int nq, int ng, int depth,
           int tiles) {
  __shared__ float sums[kWarps][kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<long long>(tiles) * nq) return;
  const int t = static_cast<int>(task / nq), i = static_cast<int>(task % nq);
  const int j_end = min(kTile, ng - t * kTile);
  float* dst = out + static_cast<size_t>(i) * ng + static_cast<size_t>(t) * kTile;
  if (*flag) {
    dense_tile(vq, vg, dst, i, t * kTile, j_end, depth, lane);
    return;
  }
  float* acc = sums[warp];
  for (int jj = lane; jj < kTile; jj += 32) acc[jj] = 0.f;  // +0.0
  __syncwarp();

  const int2* qrow = qlist + static_cast<size_t>(i) * depth;
  const int2* tile = glist + static_cast<size_t>(t) * depth * kTile;
  const int* tile_cnt = gcnt + static_cast<size_t>(t) * depth;
  const int qn = qcnt[i];
  for (int base = 0; base < qn; base += 32) {
    // Lane l holds the group's l-th non-zero k, its value and the length
    // of column k's list in this tile (0 past the group's end).
    const int m = min(32, qn - base);
    int kl = 0, cl = 0;
    float al = 0.f;
    if (lane < m) {
      const int2 e = qrow[base + lane];
      kl = e.x;
      al = __int_as_float(e.y);
      cl = tile_cnt[kl];
    }
    // ring[u]: the lane's first pair of step s0 + u; the pairs of kRing
    // steps are in flight while one step's adds run.
    int2 ring[kRing];
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
      const int k = __shfl_sync(kAll, kl, u), c = __shfl_sync(kAll, cl, u);
      ring[u] = lane < c ? tile[static_cast<size_t>(k) * kTile + lane] : make_int2(0, 0);
    }
    for (int s0 = 0; s0 < m; s0 += kRing) {
#pragma unroll
      for (int u = 0; u < kRing; ++u) {
        const int s = s0 + u;  // < 32; past m, c is 0 and the step adds nothing
        const int k = __shfl_sync(kAll, kl, s), c = __shfl_sync(kAll, cl, s);
        const float a = __shfl_sync(kAll, al, s);
        const int2 cur = ring[u];
        const int next = s + kRing;
        const int kn = __shfl_sync(kAll, kl, next & 31), cn = __shfl_sync(kAll, cl, next & 31);
        if (next < m && lane < cn) ring[u] = tile[static_cast<size_t>(kn) * kTile + lane];
        if (lane < c) acc[cur.x] += fminf(a, __int_as_float(cur.y));
        const int2* col = tile + static_cast<size_t>(k) * kTile;
        for (int p = lane + 32; p < c; p += 32) {
          const int2 e = col[p];
          acc[e.x] += fminf(a, __int_as_float(e.y));
        }
        __syncwarp();  // every add of this k lands before any of the next
      }
    }
  }

  for (int jj = lane; jj < j_end; jj += 32) dst[jj] = acc[jj];
}

}  // namespace
}  // namespace demo2

// The gallery rows of one tile: the wrapper sizes the column lists by it.
extern "C" int demo2_jaccard_tile() { return demo2::kTile; }

// Plain C entry, loaded with ctypes.  vq (nq, depth), vg (ng, depth) and out
// (nq, ng) are f32 device pointers; scratch holds, in int32 units and in
// this order, qlist (nq, depth) and glist (tiles, depth, kTile) int2 pairs,
// qcnt (nq), gcnt (tiles, depth) and the flag of a negative or NaN input,
// with tiles = ceil(ng / kTile).  Returns cudaGetLastError() after the
// launches.
extern "C" int demo2_jaccard_min_sum(const void* vq, const void* vg, void* out, void* scratch,
                                     int nq, int ng, int depth, void* stream) {
  using namespace demo2;
  if (nq < 1 || ng < 1 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (ng + kTile - 1) / kTile;
  int2* ql = static_cast<int2*>(scratch);
  int2* gl = ql + static_cast<size_t>(nq) * depth;
  int* qc = reinterpret_cast<int*>(gl + static_cast<size_t>(tiles) * depth * kTile);
  int* gc = qc + nq;
  int* fl = gc + static_cast<size_t>(tiles) * depth;
  cudaMemsetAsync(fl, 0, sizeof(int), st);
  compact_rows<<<(nq + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      static_cast<const float*>(vq), ql, qc, fl, nq, depth);
  compact_columns<<<dim3((depth + 31) / 32, tiles), kWarps * 32, 0, st>>>(
      static_cast<const float*>(vg), gl, gc, fl, ng, depth);
  const long long tasks = static_cast<long long>(tiles) * nq;
  accumulate<<<static_cast<unsigned>((tasks + kWarps - 1) / kWarps), kWarps * 32, 0, st>>>(
      static_cast<const float*>(vq), static_cast<const float*>(vg), ql, qc, gl, gc, fl,
      static_cast<float*>(out), nq, ng, depth, tiles);
  return static_cast<int>(cudaGetLastError());
}
