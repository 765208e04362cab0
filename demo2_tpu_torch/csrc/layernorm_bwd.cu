// One-pass LayerNorm backward: dx, dweight and dbias from x, dy and weight.
//
// Replaces the Pallas kernel demo2_tpu/ops/norm.py::_ln_bwd_kernel (reached
// through _ln_bwd_call from layernorm_pallas_bwd, the custom VJP behind
// TPU.PALLAS_LN_BWD), with its numerics: everything in f32, mean and the
// centered variance recomputed from x, so the forward keeps no statistics;
//   xhat = (x - mean) * rstd,  dyg = dy * weight,
//   dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))  (in dy's dtype),
//   dweight = sum over rows of dy * xhat,  dbias = sum over rows of dy  (f32).
//
// What bounds it on the card: bytes.  x and dy are read once and dx written
// once (3 R C elements: 114 MB at R = 24,768, C = 768 in bf16) against ~12
// f32 operations an element, far below the card's operations per byte.  So
// the design moves each byte once: a warp owns a row and keeps its x and dy
// in registers as the 16-byte vectors it loaded (neighbouring lanes on
// neighbouring addresses), takes the three row means by shuffle reductions,
// and writes dx from the registers; nothing is read twice and nothing but dx
// and the column partial sums is written.
//
// The column sums are deterministic.  Each block owns a contiguous range of
// rows (the TPU kernel's 256-row blocks and its zero padding are not carried
// over: the last block's range simply ends at R).  A warp accumulates
// dy * xhat and dy for its lanes' columns in registers over its rows; the
// block's warps are added in warp order through shared memory into the
// block's row of an (2, blocks, C) f32 scratch, and a second kernel adds the
// blocks' rows in a fixed order (32 interleaved partial sums per column, then
// those 32 in order).  No float atomics: two runs give the same bits.
//
// x and dy are bf16 or f32 (the template's T), C a multiple of the 16-byte
// vector (8 or 4 values) and at most 1024, which the Python wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace demo2 {
namespace {

constexpr int kLnWarps = 8;
constexpr int kLnThreads = kLnWarps * 32;
constexpr int kLnMaxCols = 1024;

// A 16-byte vector of T as kVec f32 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kVec = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[kVec]) {
    f[0] = r.x, f[1] = r.y, f[2] = r.z, f[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[kVec]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[kVec]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float ln_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lane `lane` of a warp holds, for chunk k < kChunks, the kVec columns from
// (k * 32 + lane) * kVec; kChunks * 32 * kVec >= cols.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kLnThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ weight, T* __restrict__ dx,
                     float* __restrict__ partial, int rows, int cols, int rows_per_block,
                     float eps) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  constexpr int kVec = V::kVec;
  __shared__ __align__(16) float red[kLnWarps][kLnMaxCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(rows, row0 + rows_per_block);
  const float inv_c = 1.f / static_cast<float>(cols);

  float dg[kChunks][kVec], db[kChunks][kVec];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) dg[k][v] = db[k][v] = 0.f;
  }

  for (int r = row0 + warp; r < row1; r += kLnWarps) {
    const size_t base = static_cast<size_t>(r) * cols;
    Raw xr[kChunks], dyr[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = (k * 32 + lane) * kVec;
      if (c < cols) {
        xr[k] = *reinterpret_cast<const Raw*>(x + base + c);
        dyr[k] = *reinterpret_cast<const Raw*>(dy + base + c);
      } else {
        xr[k] = V::zero();
        dyr[k] = V::zero();
      }
    }
    float xf[kVec], dyf[kVec];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      V::unpack(xr[k], xf);  // columns past C hold zeros
#pragma unroll
      for (int v = 0; v < kVec; ++v) s += xf[v];
    }
    const float mean = ln_warp_sum(s) * inv_c;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if ((k * 32 + lane) * kVec < cols) {
        V::unpack(xr[k], xf);
#pragma unroll
        for (int v = 0; v < kVec; ++v) q += (xf[v] - mean) * (xf[v] - mean);
      }
    }
    const float rstd = rsqrtf(ln_warp_sum(q) * inv_c + eps);

    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = (k * 32 + lane) * kVec;
      if (c < cols) {
        V::unpack(xr[k], xf);
        V::unpack(dyr[k], dyf);
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const float xhat = (xf[v] - mean) * rstd;
          const float dyg = dyf[v] * __ldg(weight + c + v);
          a += dyg;
          b += dyg * xhat;
          dg[k][v] += dyf[v] * xhat;
          db[k][v] += dyf[v];
        }
      }
    }
    const float m1 = ln_warp_sum(a) * inv_c;
    const float m2 = ln_warp_sum(b) * inv_c;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = (k * 32 + lane) * kVec;
      if (c < cols) {
        V::unpack(xr[k], xf);
        V::unpack(dyr[k], dyf);
        float out[kVec];
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const float xhat = (xf[v] - mean) * rstd;
          const float dyg = dyf[v] * __ldg(weight + c + v);
          out[v] = rstd * (dyg - m1 - xhat * m2);
        }
        *reinterpret_cast<Raw*>(dx + base + c) = V::pack(out);
      }
    }
  }

  // The block's column sums: the warps' registers through shared memory,
  // added in warp order; dweight first, then dbias through the same buffer.
  const int nblocks = gridDim.x;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    if (which) __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = (k * 32 + lane) * kVec;
      if (c < cols) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) red[warp][c + v] = which ? db[k][v] : dg[k][v];
      }
    }
    __syncthreads();
    float* out = partial + (static_cast<size_t>(which) * nblocks + blockIdx.x) * cols;
    for (int c = threadIdx.x; c < cols; c += kLnThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kLnWarps; ++w) s += red[w][c];
      out[c] = s;
    }
  }
}

// out[which][c] = sum over blocks of partial[which][block][c], in a fixed
// order: thread (x, y) adds blocks y, y + 32, ... of column x, then thread
// (x, 0) adds the 32 sums in order.  Grid (ceil(C / 32), 2), block (32, 32).
__global__ void __launch_bounds__(1024)
layernorm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dweight,
                            float* __restrict__ dbias, int nblocks, int cols) {
  __shared__ float red[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const float* src = partial + static_cast<size_t>(blockIdx.y) * nblocks * cols;
  float s = 0.f;
  if (c < cols) {
    for (int b = threadIdx.y; b < nblocks; b += 32) s += src[static_cast<size_t>(b) * cols + c];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 32; ++y) t += red[y][threadIdx.x];
    (blockIdx.y ? dbias : dweight)[c] = t;
  }
}

template <typename T, int kChunks>
cudaError_t launch_chunks(const void* x, const void* dy, const float* weight, void* dx,
                          float* partial, int rows, int cols, int nblocks, float eps,
                          cudaStream_t st) {
  const int rows_per_block = (rows + nblocks - 1) / nblocks;
  layernorm_bwd_kernel<T, kChunks><<<nblocks, kLnThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), weight, static_cast<T*>(dx), partial,
      rows, cols, rows_per_block, eps);
  return cudaGetLastError();
}

// One instance per number of 16-byte chunks a lane holds (1 .. kMax), so the
// row's registers are sized for C and not for the widest row.
template <typename T>
cudaError_t launch_layernorm_bwd(const void* x, const void* dy, const float* weight, void* dx,
                                 float* partial, int rows, int cols, int nblocks, float eps,
                                 cudaStream_t st) {
  constexpr int kVec = Vec<T>::kVec;
  const int chunks = (cols + 32 * kVec - 1) / (32 * kVec);
#define DEMO2_LN_CASE(n)                                                                   \
  case n:                                                                                  \
    return launch_chunks<T, n>(x, dy, weight, dx, partial, rows, cols, nblocks, eps, st)
  switch (chunks) {
    DEMO2_LN_CASE(1);
    DEMO2_LN_CASE(2);
    DEMO2_LN_CASE(3);
    DEMO2_LN_CASE(4);
    default:
      break;
  }
  if constexpr (kVec == 4) {
    switch (chunks) {
      DEMO2_LN_CASE(5);
      DEMO2_LN_CASE(6);
      DEMO2_LN_CASE(7);
      DEMO2_LN_CASE(8);
      default:
        break;
    }
  }
#undef DEMO2_LN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace demo2

// Plain C entry, loaded with ctypes.  x, dy and dx (rows, cols) are bf16
// (is_bf16 != 0) or f32 device pointers, weight (cols,) f32, partial
// (2, nblocks, cols) f32 scratch, dweight and dbias (cols,) f32 outputs.
// Block b takes rows [b * ceil(rows / nblocks), ...).  Returns the first
// non-zero cudaGetLastError() of its two launches, else 0.
extern "C" int demo2_layernorm_bwd(const void* x, const void* dy, const void* weight, void* dx,
                                   void* partial, void* dweight, void* dbias, int rows, int cols,
                                   int nblocks, int is_bf16, float eps, void* stream) {
  using namespace demo2;
  if (rows < 1 || nblocks < 1 || cols < 1 || cols > kLnMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weight);
  float* scratch = static_cast<float*>(partial);
  const cudaError_t err =
      is_bf16 ? launch_layernorm_bwd<__nv_bfloat16>(x, dy, w, dx, scratch, rows, cols, nblocks,
                                                     eps, st)
              : launch_layernorm_bwd<float>(x, dy, w, dx, scratch, rows, cols, nblocks, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  layernorm_bwd_reduce_kernel<<<dim3((cols + 31) / 32, 2), dim3(32, 32), 0, st>>>(
      scratch, static_cast<float*>(dweight), static_cast<float*>(dbias), nblocks, cols);
  return static_cast<int>(cudaGetLastError());
}
