// Shared pieces of the ViT block kernels and the attention headers: the
// LayerNorm pass of kernels 1-3 (the block's t = LN(x), once per row), the
// bf16 <-> f32 vector helpers, ldmatrix for the attention tiles, and the
// persistent grid, mbarrier and tensor-map (TMA) primitives of every TMA-fed
// kernel: gemm_sm90.cuh (the block GEMMs) and attention_regs_fwd.cuh /
// attention_regs_bwd.cuh.
//
// LayerNorm stays its own pass.  Measured on the H100 (PERF.md): applying it
// in the GEMM's A-load, as the Pallas kernels do in VMEM, re-normalised the
// same rows once per column tile (18x for qkv, 24x for fc1) and ran those two
// GEMMs 35-40% slower than the same GEMMs after one pass that writes t once.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace demo2 {
namespace {

using bf16 = __nv_bfloat16;

// ---- bf16 <-> f32 for 16-byte vectors of 8 values --------------------------

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// Two f32 values as one register of two bf16, x in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float x, float y) {
  return bf16_bits(x) | (bf16_bits(y) << 16);
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

// ---- ldmatrix --------------------------------------------------------------

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row (l % 8) of matrix (l / 8).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ---- persistent grids, mbarriers and the tensor-map encoder (TMA) ----------

// One block an SM of the current device, or one an item where those are fewer.
inline cudaError_t persistent_grid(int items, int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *grid = items < sms ? items : sms;
  return cudaSuccess;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed (its n-th
// completion has parity n & 1, n from 0).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Orders this thread's shared-memory accesses before later TMA copies.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled's signature.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up in the loaded libcuda at the
// first call, so that the library itself links the CUDA runtime only; null
// where there is none.
inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    void* fn = libcuda != nullptr ? dlsym(libcuda, "cuTensorMapEncodeTiled") : nullptr;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  return encode;
}

}  // namespace
}  // namespace demo2
