// Shared pieces of the ViT block kernels: the LayerNorm pass and a tiled bf16
// tensor-core GEMM template whose epilogue (bias, QuickGELU, residual) is a
// pluggable functor.
//
// C[M, N] = epilogue(A[M, K] @ W[N, K]^T)
//   A  row-major (M, K) bf16 activations;
//   W  row-major (N, K) bf16 weights, i.e. torch's Linear layout (out, in);
//   accumulation in f32 on the tensor cores (mma.sync m16n8k16).
//
// Tiling: 128 x 128 output tile per 256-thread block, 8 warps in a 2 x 4
// grid, each owning a 64 x 32 sub-tile (4 x 4 mma tiles of 16 x 8).  K is
// walked in 32-wide slices through a 4-stage shared-memory ring filled by
// cp.async (80 KB of dynamic shared memory, two blocks per SM), so three
// slices' loads are in flight while one is multiplied; one __syncthreads per
// slice.  Fragments come from shared memory by ldmatrix (80-byte rows: no
// bank conflicts).  Ragged M and N edges are zero-filled on load and masked
// on store; K and N must be multiples of 8 (16-byte vectors), which the
// Python wrapper checks.
//
// Measured on the H100 (PERF.md): an earlier version applied the LayerNorm
// in the GEMM's A-load, as the Pallas kernels do in VMEM; each of the N / 128
// column blocks then re-normalised the same rows (18x for qkv, 24x for fc1),
// and those two GEMMs ran at ~120-127
// TFLOP/s against ~180-205 for the same build's GEMMs without it.  LayerNorm
// is now one pass that writes t once.  Hopper's TMA + wgmma pipeline is later
// work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace demo2 {
namespace {

using bf16 = __nv_bfloat16;

// ---- bf16 <-> f32 for 16-byte vectors of 8 values --------------------------

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- LayerNorm --------------------------------------------------------------
// One warp per row: mean, then the centered two-pass variance, both in f32,
// then t = bf16(((x - mean) * rstd) * scale + bias)
// (demo2_tpu/ops/fused_block.py::_layernorm_f32, cast to the compute dtype).

__global__ void __launch_bounds__(256)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ t, int rows, int width,
                 float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * width);
  uint4* dst = reinterpret_cast<uint4*>(t + static_cast<size_t>(row) * width);
  const int nvec = width / 8;
  float f[8];
  float s = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    unpack8(src[v], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mean = warp_sum(s) / width;
  float q = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    unpack8(src[v], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) q += (f[i] - mean) * (f[i] - mean);
  }
  const float rstd = rsqrtf(warp_sum(q) / width + eps);
  for (int v = lane; v < nvec; v += 32) {
    unpack8(src[v], f);
    const float4* s4 = reinterpret_cast<const float4*>(scale + v * 8);
    const float4* b4 = reinterpret_cast<const float4*>(bias + v * 8);
    const float4 sa = s4[0], sb = s4[1], ba = b4[0], bb = b4[1];
    const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = ((f[i] - mean) * rstd) * sc[i] + bi[i];
    dst[v] = pack8(f);
  }
}

inline cudaError_t launch_layernorm(const bf16* x, const float* scale, const float* bias,
                                    bf16* t, int rows, int width, cudaStream_t stream) {
  const int warps_per_block = 256 / 32;
  const int blocks = (rows + warps_per_block - 1) / warps_per_block;
  layernorm_kernel<<<blocks, 256, 0, stream>>>(x, scale, bias, t, rows, width, 1e-5f);
  return cudaGetLastError();
}

// ---- Epilogues: consume 8 f32 accumulators of (row, col..col+7) -------------

// out = bf16(acc + bias)
struct BiasEpilogue {
  bf16* out;
  const float* bias;
  int ldo;
  __device__ __forceinline__ void operator()(int row, int col, float (&acc)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += bias[col + i];
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * ldo + col) = pack8(acc);
  }
};

// h = acc + bias (f32); out = bf16(h * sigmoid(1.702 h))
struct BiasQuickGeluEpilogue {
  bf16* out;
  const float* bias;
  int ldo;
  __device__ __forceinline__ void operator()(int row, int col, float (&acc)[8]) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float h = acc[i] + bias[col + i];
      acc[i] = h * (1.f / (1.f + expf(-1.702f * h)));
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * ldo + col) = pack8(acc);
  }
};

// The same, and the pre-GELU hidden beside it: hidden = bf16(h), with g still
// taken from the f32 h (fused_block.py::_mlp_kernel, which training reads).
struct BiasQuickGeluHiddenEpilogue {
  bf16* out;
  bf16* hidden;
  const float* bias;
  int ldo;
  __device__ __forceinline__ void operator()(int row, int col, float (&acc)[8]) const {
    const size_t off = static_cast<size_t>(row) * ldo + col;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += bias[col + i];
    *reinterpret_cast<uint4*>(hidden + off) = pack8(acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = acc[i] * (1.f / (1.f + expf(-1.702f * acc[i])));
    *reinterpret_cast<uint4*>(out + off) = pack8(acc);
  }
};

// y = bf16(acc + bias); out = bf16(resid + y): the residual add in bf16.
struct BiasResidualBf16Epilogue {
  bf16* out;
  const float* bias;
  const bf16* resid;
  int ldo;
  __device__ __forceinline__ void operator()(int row, int col, float (&acc)[8]) const {
    const size_t off = static_cast<size_t>(row) * ldo + col;
    float r[8];
    unpack8(*reinterpret_cast<const uint4*>(resid + off), r);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = __bfloat162float(__float2bfloat16_rn(acc[i] + bias[col + i]));
      acc[i] = r[i] + y;
    }
    *reinterpret_cast<uint4*>(out + off) = pack8(acc);
  }
};

// out = bf16(resid + (acc + bias)): the residual add in f32.
struct BiasResidualF32Epilogue {
  bf16* out;
  const float* bias;
  const bf16* resid;
  int ldo;
  __device__ __forceinline__ void operator()(int row, int col, float (&acc)[8]) const {
    const size_t off = static_cast<size_t>(row) * ldo + col;
    float r[8];
    unpack8(*reinterpret_cast<const uint4*>(resid + off), r);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = r[i] + (acc[i] + bias[col + i]);
    *reinterpret_cast<uint4*>(out + off) = pack8(acc);
  }
};

// ---- Tensor-core and async-copy primitives ----------------------------------

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// !valid (the source must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row (l % 8) of matrix (l / 8).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- The GEMM ---------------------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kStages = 4;                   // cp.async ring depth
constexpr int kLds = kBK + 8;                // smem row stride in bf16 (80 bytes)
constexpr int kTileElems = kBM * kLds;       // one operand tile (kBM == kBN)
constexpr int kStageElems = 2 * kTileElems;  // A tile + W tile
constexpr int kGemmSmemBytes = kStages * kStageElems * static_cast<int>(sizeof(bf16));
constexpr int kLdE = 32 + 4;                 // f32 epilogue staging row stride
static_assert(8 * 64 * kLdE * 4 <= kGemmSmemBytes, "epilogue staging must fit the ring");

template <class Epilogue>
__global__ void __launch_bounds__(kThreads, 2)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int M, int N, int K,
                 Epilogue epilogue) {
  // kStages x [A tile | W tile], each [row * kLds + k]; reused as the f32
  // epilogue staging area once the K loop is done.
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* smem = reinterpret_cast<bf16*>(gemm_smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int wm = warp >> 2;  // 0..1: 64-row band
  const int wn = warp & 3;   // 0..3: 32-column band

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + kBK - 1) / kBK;

  // Each thread copies two 16-byte vectors of A and two of W per K slice: a
  // 128 x 32 tile is 512 vectors, 4 per row.
  auto issue = [&](int kt) {
    bf16* As = smem + (kt % kStages) * kStageElems;
    bf16* Ws = As + kTileElems;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      const int r = v >> 2;
      const int c = (v & 3) * 8;
      const int k = kt * kBK + c;
      const bool a_ok = m0 + r < M && k < K;
      const bool w_ok = n0 + r < N && k < K;
      cp_async16(As + r * kLds + c, a_ok ? A + static_cast<size_t>(m0 + r) * K + k : A, a_ok);
      cp_async16(Ws + r * kLds + c, w_ok ? W + static_cast<size_t>(n0 + r) * K + k : W, w_ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) issue(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice kt have landed
    __syncthreads();               // ... and everyone's; slice kt-1's buffer is free
    if (kt + kStages - 1 < ktiles) issue(kt + kStages - 1);
    cp_async_commit();
    const bf16* As = smem + (kt % kStages) * kStageElems;
    const bf16* Ws = As + kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // rows 0-15 at k+0 (lanes 0-15), k+8 (lanes 16-31)
        ldmatrix_x4(a[i], As + (wm * 64 + i * 16 + (lane & 15)) * kLds + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, ...)
        ldmatrix_x4(b[j], Ws + (wn * 32 + j * 16 + ((lane >> 4) << 3) + (lane & 7)) * kLds +
                              kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[i][nt], a[i], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: each warp stages its 64 x 32 f32 tile in shared memory (mma
  // layout: c0,c1 at row lane/4, columns 2(lane%4)+{0,1}; c2,c3 eight rows
  // down), then each lane hands rows of 8 columns to the epilogue.
  float* stage = reinterpret_cast<float*>(gemm_smem) + warp * (64 * kLdE);
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* p = stage + (i * 16 + g) * kLdE + nt * 8 + tq * 2;
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][nt][0], acc[i][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * kLdE) = make_float2(acc[i][nt][2], acc[i][nt][3]);
    }
  __syncwarp();
#pragma unroll
  for (int it = lane; it < 64 * 4; it += 32) {
    const int row = it >> 2;
    const int cg = (it & 3) * 8;
    const int gm = m0 + wm * 64 + row;
    const int gn = n0 + wn * 32 + cg;
    if (gm < M && gn < N) {
      const float4 lo = *reinterpret_cast<const float4*>(stage + row * kLdE + cg);
      const float4 hi = *reinterpret_cast<const float4*>(stage + row * kLdE + cg + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      epilogue(gm, gn, v);
    }
  }
}

template <class Epilogue>
cudaError_t launch_gemm(const bf16* A, const bf16* W, int M, int N, int K, Epilogue epilogue,
                        cudaStream_t stream) {
  auto kernel = gemm_bf16_kernel<Epilogue>;
  // Above 48 KB, dynamic shared memory needs the opt-in.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kGemmSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kGemmSmemBytes, stream>>>(A, W, M, N, K, epilogue);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2
