// wgmma (Hopper's warpgroup matrix multiply) at the shapes the block kernels'
// long forward (attention_long_block.cuh) runs: m64nNk16, bf16 operands, f32
// accumulators, for N = 32 (QK^T, a chunk of 32 keys) and 64 (PV, the head's
// columns).  LongMma<N>::rs takes A (64 x 16) from registers, each warp of the
// warpgroup its 16 rows in the A-fragment layout of mma.sync m16n8k16, and B
// from shared memory through a descriptor (gemm_sm90.cuh::wgmma_desc,
// K-major, or ::wgmma_desc_mn, MN-major with kTransB = 1).  d (64 x N) is the
// warpgroup's accumulator layout: d[4 j + e] at row 16 w + lane / 4 + 8 (e /
// 2), column 8 j + 2 (lane % 4) + e % 2 for warp w; `accumulate` 0
// overwrites d.  The products are asynchronous: wgmma_fence before, then
// wgmma_commit and wgmma_wait (gemm_sm90.cuh) before d or the A registers are
// touched again.  gemm_sm90.cuh's wgmma_m64n192k16 is the same instruction
// at N = 192.

#pragma once

#include "gemm_sm90.cuh"

namespace demo2 {
namespace {

template <int N>
struct LongMma;

template <>
struct LongMma<32> {
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
          "n"(kTransB));
  }
};

template <>
struct LongMma<64> {
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
          "n"(kTransB));
  }
};

// Keeps the compiler from moving reads or writes of an accumulator across the
// asynchronous products (as gemm_sm90.cuh::fence_accumulators).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace
}  // namespace demo2
