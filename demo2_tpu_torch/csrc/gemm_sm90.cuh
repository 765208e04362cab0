// The block GEMM on Hopper: C[M, N] = epilogue(A[M, K] @ W[N, K]^T), bf16
// operands, f32 accumulation on the tensor cores by wgmma, for the four
// products of the ViT block kernels (fused_attention_block.cu: kernels 1 and
// 3; fused_mlp_block.cu: kernel 2 in both forms), which replace the Pallas
// kernels demo2_tpu/ops/fused_block.py::_fwd_kernel_infer, ::_fwd_kernel and
// ::_mlp_kernel, and for kernel 8's two products (attention_bwd.cu, below).
// For the block kernels A is row-major (M, K), W row-major (N, K): torch's
// Linear layout (out, in), K-major, the layout wgmma takes for B without its
// transpose bit.  The epilogue (below) takes the f32 accumulators of two
// neighbouring columns of one row and rounds where the Pallas kernel rounds.
//
// What bounds it on an H100: at the flagship shape (M = 192 x 129 = 24,768
// rows, C = 768) the products are qkv 87.7 GFLOP (0.089 ms at the 989 TFLOP/s
// bf16 peak; 156 MB to move, 0.046 ms at 3.35 TB/s), out-proj 29.2 GFLOP
// (0.030 ms; 115 MB with the residual, 0.034 ms: bytes), fc1 116.9 GFLOP
// (0.118 ms; 195 MB, 347 MB with the training form's h) and fc2 116.9 GFLOP
// (0.118 ms; 233 MB): all but out-proj are bound by the tensor cores.  The
// first design (mma.sync m16n8k16 fed by ldmatrix from a cp.async ring, a
// block barrier every 32-wide K slice, 128 x 128 tiles, two blocks an SM)
// reached 20-26% of the peak; wgmma is the only way to the card's full
// tensor-core rate.
//
// The design:
//   * Warp roles.  384 threads: warpgroup 0 is the producer, whose first
//     thread issues every TMA load of A and W (the rest of it exits at once,
//     after handing its registers over with setmaxnreg); warpgroups 1 and 2
//     are the consumers, each owning 64 rows of a 128 x 192 output tile (96
//     f32 accumulators a thread, one m64n192k16 wgmma per 16-wide K step).
//   * Loads.  A ring of four K slices of 64 (128-byte rows, the TMA's
//     128-byte swizzle, which the wgmma descriptors name): per slice one 2-d
//     TMA copy of A (128 x 64) and one of W (192 x 64), 40 KB, completion
//     counted on the slice's `full` mbarrier; each consumer warp arrives on
//     its `empty` mbarrier once the wgmma that read the slice has completed
//     (one wgmma group stays in flight).  Ragged M, N and K edges are the
//     copy engine's zero fill.  The producer never runs more than a ring
//     ahead, since it waits on `empty`, so the parity waits tell the phases
//     apart.
//   * Persistence.  One block an SM walks the output tiles t = blockIdx.x,
//     + gridDim.x, ..., the N tiles of an M tile in turn (A's 128 rows are
//     read once from device memory, W stays in L2).  The producer goes on
//     to the next tile's slices while the consumers run the epilogue.
//   * The tile width.  192 divides every width of ViT-B (768 = 4 x 192,
//     2,304 = 12 x 192, 3,072 = 16 x 192): no ragged column tile at the
//     flagship shape.  At N = 768, 194 M tiles give 776 tiles of 128 x 192,
//     5.9 rounds of 132 SMs (a 128 x 256 tile: 582, 4.4 rounds, the last at
//     41%), at N = 2,304 2,328 (17.6), at N = 3,072 3,104 (23.5).
//   * Epilogue.  Each consumer warpgroup owns a 64 x 192 bf16 staging tile
//     in shared memory (three 64 x 64 boxes under the 128-byte swizzle, so
//     the 4-byte pairs of eight rows a warp writes fall in distinct banks).
//     The pairs go there, and one thread stores the three boxes with TMA
//     (rows >= M and columns >= N clipped by the copy engine) while the
//     warpgroup starts its next tile.  The residual tile (x) is loaded by TMA
//     into the same staging tile during the mainloop, and each thread reads
//     its pair where it then writes the sum.  The training form's h goes out
//     through the staging tile first, then g.
// Measured (H100 80GB HBM3 at 700 W, flagship shape, profiler device time
// inside the block kernels' own launches, chip_smoke.py's [gemm] lines, beside
// one torch.addmm at the same shape): qkv 0.136 ms (645 TFLOP/s; addmm 0.131),
// out-proj 0.063 (466; 0.046), fc1 0.223 (525; 0.171 without the GELU), fc1
// with h 0.284, fc2 0.169 (690; 0.153): cuBLAS's rate on qkv, 72-90% of it on
// the rest.  What the epilogue costs is not overlapped with the products (both
// consumer warpgroups run it at once), which the K = 768 products feel most.
// On the way, the pairs written straight from the accumulators to device
// memory (4 bytes a thread in stripes of eight rows, the bias and residual
// read between the stores) made a K = 768 tile's epilogue longer than its
// products: hence the staging tile and the TMA stores.
//
// Kernel 8's two products (attention_bwd.cu) run on the same kernel with
// other operand forms, chosen by two template parameters whose defaults are
// the K-major forms above:
//   * dt = dqkv W: A is dqkv (B*S, 3C), K-major; B is W (3C, C) in torch's
//     Linear layout, that is (K, N) with N contiguous: MN-major.  The epilogue
//     rounds the f32 sum over the whole K = 3C to bf16 once, with no bias
//     (RoundEpilogue).
//   * dW = dqkv^T t: A is dqkv read as its transpose, (K = B*S, M = 3C) with M
//     contiguous, and B is t (K = B*S, N = C) with N contiguous: both
//     MN-major.  The output has only (3C / 128) x (C / 192) tiles (72 at
//     ViT-B), so K is cut into slices of a fixed number of rows and a work
//     unit is a (slice, tile) pair; each unit stores its f32 sums straight
//     from the accumulators to its own (3C, C) partial (F32Epilogue), and a
//     second pass adds the partials in slice order.  The slices depend on the
//     shape alone, so the bits do not depend on the card's SM count.
// An MN-major operand comes in as boxes of 64 M (or N) x 64 K: 64 rows, one a
// K index, of 128 bytes under the same 128-byte swizzle (two boxes for A's 128
// rows, three for W's 192 columns), 40 KB a slice as before.  In the wgmma
// descriptor the 8-row K groups are 1,024 bytes apart (SBO) and the 64-wide
// boxes 8,192 bytes (LBO); a 16-deep K step is 16 rows further (2,048 bytes,
// where the K-major form steps 32 bytes along a row), and the instruction's
// transpose bit for that operand is set.  The transpose bit names which
// storage dimension is contiguous, not a mathematical transpose.
// TMA's rule for every map: the contiguous dimension of each operand and of
// the output a multiple of 8 (16-byte row strides); the other dimension is
// free, its ragged edge the copy engine's zero fill (K, for the MN-major
// operands) or clipped on store (the output's rows).
// Resources (nvcc 12.9, -Xptxas -v, sm_90a): 168 registers at entry (the
// launch bound of 384 threads; the consumers raise theirs to 232 with
// setmaxnreg), no spills but in the training form's fc1 (128-byte stack, 124
// bytes of spill stores: its two passes hold the bias pairs across the first
// store), 213,072 bytes of dynamic shared memory, one block an SM.

#pragma once

#include "gemm.cuh"

namespace demo2 {
namespace {

constexpr int kGemmBM = 128;                 // rows of an output tile: two warpgroups of 64
constexpr int kGemmBN = 192;                 // columns of an output tile
constexpr int kGemmBK = 64;                  // a K slice: 128-byte rows, one swizzle span
constexpr int kGemmStages = 4;               // K slices in the ring
constexpr int kGemmThreads = 384;            // the producer warpgroup and two consumers
constexpr int kGemmAcc = kGemmBN / 2;        // f32 accumulators of a consumer thread
constexpr int kGemmBox = 64;                 // rows and columns of an epilogue TMA box
constexpr int kGemmATile = kGemmBM * kGemmBK * static_cast<int>(sizeof(bf16));
constexpr int kGemmWTile = kGemmBN * kGemmBK * static_cast<int>(sizeof(bf16));
constexpr int kGemmStageBytes = kGemmATile + kGemmWTile;
constexpr int kGemmBoxBytes = kGemmBox * kGemmBox * static_cast<int>(sizeof(bf16));
constexpr int kGemmOutTile = (kGemmBN / kGemmBox) * kGemmBoxBytes;  // a warpgroup's staging
constexpr int kGemmRingBytes = kGemmStages * kGemmStageBytes;
constexpr int kGemmSmemBytes = kGemmRingBytes + 2 * kGemmOutTile + (2 * kGemmStages + 2) * 8;
static_assert(kGemmATile % 1024 == 0 && kGemmWTile % 1024 == 0 && kGemmBoxBytes % 1024 == 0,
              "swizzled tiles start on 1024 bytes");
static_assert(kGemmSmemBytes <= 232448, "the ring and the staging tiles must fit one SM");
static_assert(kGemmBN == 192 && kGemmBN % kGemmBox == 0 && kGemmBox == kGemmBK,
              "wgmma_m64n192k16 is written for 192 columns; every box is one swizzle span");

// ---- Epilogues ----------------------------------------------------------------
// Each maps the f32 accumulators a0, a1 of two neighbouring columns of one
// row, their bias pair b (added in f32 by every epilogue) and, for kResidual,
// the residual pair r (two bf16 in a register, the lower column in the low
// half) to the two bf16 of the output, rounded where the Pallas kernel rounds.
// kHidden also writes the pre-GELU hidden, hidden().  kF32 stores the f32
// accumulators themselves, with no staging tile (F32Epilogue).
enum class Aux { kNone, kResidual, kHidden, kF32 };

// out = bf16(acc + bias): the qkv projection.
struct BiasEpilogue {
  static constexpr Aux kAux = Aux::kNone;
  static constexpr bool kBias = true;
  __device__ static uint32_t out(float a0, float a1, float2 b, uint32_t) {
    return pack_bf16x2(a0 + b.x, a1 + b.y);
  }
};

// h * sigmoid(1.702 h) in f32 as _mlp_kernel and the plain version compute
// it, h * (1 / (1 + exp(-1.702 h))) with the accurate expf.  The reciprocal
// of y >= 1 is rcp.approx refined by one Newton step, the correctly rounded
// 1 / y but for rare ties (0 where y overflows, as 1 / inf): the division
// operator's slow-path branch after every element kept the compiler from
// interleaving a thread's 96 of them, which made fc1's epilogue longer than
// its products.
__device__ __forceinline__ float quick_gelu(float h) {
  const float y = 1.f + expf(-1.702f * h);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
  r = fmaf(fmaf(-y, r, 1.f), r, r);
  return h * (isinf(y) ? 0.f : r);
}

// h = acc + bias (f32); out = bf16(h * sigmoid(1.702 h)): fc1 at eval.
struct BiasQuickGeluEpilogue {
  static constexpr Aux kAux = Aux::kNone;
  static constexpr bool kBias = true;
  __device__ static uint32_t out(float a0, float a1, float2 b, uint32_t) {
    return pack_bf16x2(quick_gelu(a0 + b.x), quick_gelu(a1 + b.y));
  }
};

// The same, and the pre-GELU hidden beside it: hidden = bf16(h), with g still
// taken from the f32 h (fused_block.py::_mlp_kernel, which training reads).
struct BiasQuickGeluHiddenEpilogue {
  static constexpr Aux kAux = Aux::kHidden;
  static constexpr bool kBias = true;
  __device__ static uint32_t hidden(float a0, float a1, float2 b) {
    return pack_bf16x2(a0 + b.x, a1 + b.y);
  }
  __device__ static uint32_t out(float a0, float a1, float2 b, uint32_t) {
    return BiasQuickGeluEpilogue::out(a0, a1, b, 0u);
  }
};

// y = bf16(acc + bias); out = bf16(resid + y): the out-projection, the
// residual added in bf16.
struct BiasResidualBf16Epilogue {
  static constexpr Aux kAux = Aux::kResidual;
  static constexpr bool kBias = true;
  __device__ static uint32_t out(float a0, float a1, float2 b, uint32_t r) {
    const float y0 = __bfloat162float(__float2bfloat16_rn(a0 + b.x));
    const float y1 = __bfloat162float(__float2bfloat16_rn(a1 + b.y));
    return pack_bf16x2(__uint_as_float(r << 16) + y0, __uint_as_float(r & 0xffff0000u) + y1);
  }
};

// out = bf16(resid + (acc + bias)): fc2, the residual added in f32.
struct BiasResidualF32Epilogue {
  static constexpr Aux kAux = Aux::kResidual;
  static constexpr bool kBias = true;
  __device__ static uint32_t out(float a0, float a1, float2 b, uint32_t r) {
    return pack_bf16x2(__uint_as_float(r << 16) + (a0 + b.x),
                       __uint_as_float(r & 0xffff0000u) + (a1 + b.y));
  }
};

// out = bf16(acc), no bias: kernel 8's dt, its f32 sum over K rounded once.
struct RoundEpilogue {
  static constexpr Aux kAux = Aux::kNone;
  static constexpr bool kBias = false;
  __device__ static uint32_t out(float a0, float a1, float2, uint32_t) {
    return pack_bf16x2(a0, a1);
  }
};

// The f32 sums as they are, to the work unit's own partial: kernel 8's dW.
struct F32Epilogue {
  static constexpr Aux kAux = Aux::kF32;
  static constexpr bool kBias = false;
};

// ---- wgmma, TMA -----------------------------------------------------------------

// Which storage dimension of an operand is contiguous: K (A (M, K); W (N, K),
// torch's Linear layout) or M / N (A stored as (K, M), W as (K, N)).
enum class Major { kK, kMN };

// The shared-memory descriptor of a K-major tile of 128-byte rows under the
// 128-byte swizzle, starting on 1024 bytes: 8-row groups 1,024 bytes apart
// (SBO), the leading offset unused (a 16-wide K step lies inside one row).
// The K step kk of a slice is the descriptor + 2 kk (32 bytes further).
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// The descriptor of an MN-major tile: boxes of 64 rows (K) x 128 bytes (64
// M or N) under the 128-byte swizzle, kGemmBoxBytes apart (LBO: the next 64
// of M or N), starting on 1024 bytes; 8-row K groups 1,024 bytes apart (SBO).
// The K step kk of a slice is 16 rows further: the descriptor + 128 kk.
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (uint64_t{kGemmBoxBytes >> 4} << 16) | (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}
template <Major kMajor>
__device__ __forceinline__ uint64_t operand_desc(const void* tile) {
  return kMajor == Major::kK ? wgmma_desc(tile) : wgmma_desc_mn(tile);
}
// How far a 16-deep K step moves an operand's descriptor (16-byte units).
template <Major kMajor>
constexpr int kDescStep = kMajor == Major::kK ? 2 : 16 * 128 / 16;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products (they are operands of no instruction in between).
__device__ __forceinline__ void fence_accumulators(float (&d)[kGemmAcc]) {
#pragma unroll
  for (int i = 0; i < kGemmAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 192, the warpgroup's accumulator layout) (+)= A (64 x 16) B^T with
// A and B (192 x 16) in shared memory, each K-major or, with its transpose
// bit (kTransA, kTransB), MN-major; `accumulate` 0 overwrites d.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[kGemmAcc], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// The box at (x: column, y: row) of a 2-d tensor map to the swizzled tile at
// dst; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
// The swizzled tile at src to the box at (x, y) of a 2-d tensor map, in this
// thread's current bulk group; the part outside the tensor is not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int x,
                                             int y) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(x), "r"(y)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// The 128 threads of consumer warpgroup `half` (named barriers 1 and 2).
__device__ __forceinline__ void warpgroup_sync(int half) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
}

// ---- the kernel -------------------------------------------------------------------

// The staging tile's 4-byte pair at row r (0-63) and columns c, c + 1 (c even,
// 0-190): box c / 64, chunk (c % 64) / 8 of the row swizzled by r % 8.
__device__ __forceinline__ uint32_t* staged_pair(unsigned char* tile, int r, int c) {
  return reinterpret_cast<uint32_t*>(tile + (c >> 6) * kGemmBoxBytes + r * 128 +
                                     ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// One consumer thread's pairs (rows r0 and r0 + 8 of its warpgroup's 64) into
// the staging tile: hidden() where kHiddenPass, else out() (reading the
// residual pair in place first where kResidual).
template <class Epilogue, bool kHiddenPass>
__device__ __forceinline__ void stage_pairs(unsigned char* tile, const float (&d)[kGemmAcc],
                                            const float* __restrict__ bias, int n0, int N,
                                            int r0, int lane) {
#pragma unroll
  for (int i = 0; i < kGemmBN / 8; ++i) {
    const int c = i * 8 + 2 * (lane & 3);
    const float2 b = Epilogue::kBias && n0 + c < N
                         ? __ldg(reinterpret_cast<const float2*>(bias + n0 + c))
                         : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t* slot = staged_pair(tile, r0 + 8 * h, c);
      const float a0 = d[4 * i + 2 * h], a1 = d[4 * i + 2 * h + 1];
      if constexpr (kHiddenPass) {
        *slot = Epilogue::hidden(a0, a1, b);
      } else {
        *slot = Epilogue::out(a0, a1, b, Epilogue::kAux == Aux::kResidual ? *slot : 0u);
      }
    }
  }
}

// The staging tile to the output at (n0, row0) by its leader thread: the
// pairs are fenced for the copy engine, the warpgroup meets, the leader
// issues the three box stores.
__device__ __forceinline__ void store_staged(unsigned char* tile, const CUtensorMap* map, int n0,
                                             int row0, int half, bool leader) {
  fence_async_proxy();
  warpgroup_sync(half);
  if (leader) {
#pragma unroll
    for (int box = 0; box < kGemmBN / kGemmBox; ++box) {
      tma_store_2d(map, tile + box * kGemmBoxBytes, n0 + box * kGemmBox, row0);
    }
    bulk_commit();
  }
}

// One consumer thread's f32 pairs (rows r and r + 8 of the output, columns
// n0 + 8 i + 2 (lane % 4) and the next) straight to out (M, N): a quad writes
// 32 consecutive bytes, a whole sector; rows >= M and columns >= N are not
// written.
__device__ __forceinline__ void store_f32_pairs(float* out, const float (&d)[kGemmAcc], int r,
                                                int n0, int M, int N, int lane) {
#pragma unroll
  for (int i = 0; i < kGemmBN / 8; ++i) {
    const int c = n0 + i * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + 8 * h < M && c < N) {
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8 * h) * N + c) =
            make_float2(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
      }
    }
  }
}

// A's slice kt of the tile at row (or column, MN-major) m0 into a_s, W's at n0
// into w_s, both counted on `bar`.
template <Major kMajorA, Major kMajorW>
__device__ __forceinline__ void load_slice(unsigned char* a_s, unsigned char* w_s,
                                           const CUtensorMap* a_map, const CUtensorMap* w_map,
                                           int k, int m0, int n0, uint64_t* bar) {
  if constexpr (kMajorA == Major::kK) {
    tma_load_2d(a_s, a_map, k, m0, bar);
  } else {
#pragma unroll
    for (int box = 0; box < kGemmBM / kGemmBox; ++box) {
      tma_load_2d(a_s + box * kGemmBoxBytes, a_map, m0 + box * kGemmBox, k, bar);
    }
  }
  if constexpr (kMajorW == Major::kK) {
    tma_load_2d(w_s, w_map, k, n0, bar);
  } else {
#pragma unroll
    for (int box = 0; box < kGemmBN / kGemmBox; ++box) {
      tma_load_2d(w_s + box * kGemmBoxBytes, w_map, n0 + box * kGemmBox, k, bar);
    }
  }
}

// Work unit u of `units` = tiles x splits: output tile u % tiles over the K
// slices of split u / tiles, split_slices of them (the last split fewer).
// Only Aux::kF32 splits K; every other epilogue's unit is its tile, over all
// of K, with the unit arithmetic folded away at compile time.
template <class Epilogue, Major kMajorA, Major kMajorW>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap out_map,
                 const __grid_constant__ CUtensorMap aux_map, const float* __restrict__ bias,
                 float* __restrict__ out_f32, int M, int N, int K, int split_slices) {
  // [ring: stages x (A | W)] [staging: 2 x 64 x 192] [full] [empty] [aux]
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(gemm_smem + kGemmRingBytes + 2 * kGemmOutTile);
  uint64_t* empty = full + kGemmStages;
  uint64_t* aux_full = empty + kGemmStages;  // a consumer warpgroup's residual tile
  const int n_tiles = (N + kGemmBN - 1) / kGemmBN;
  const int tiles = (M + kGemmBM - 1) / kGemmBM * n_tiles;
  const int slices = (K + kGemmBK - 1) / kGemmBK;
  constexpr bool kSplit = Epilogue::kAux == Aux::kF32;
  const int units = kSplit ? tiles * ((slices + split_slices - 1) / split_slices) : tiles;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    mbar_init(aux_full, 1);
    mbar_init(aux_full + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t round = 0;  // parity of the ring's pass
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
        const int tile = kSplit ? unit % tiles : unit;
        const int m0 = tile / n_tiles * kGemmBM;
        const int n0 = tile % n_tiles * kGemmBN;
        const int kt0 = kSplit ? unit / tiles * split_slices : 0;
        const int kt1 = kSplit ? min(slices, kt0 + split_slices) : slices;
        for (int kt = kt0; kt < kt1; ++kt) {
          mbar_wait(empty + stage, round ^ 1);  // the pass before released the slot
          unsigned char* a_s = gemm_smem + stage * kGemmStageBytes;
          mbar_arrive_expect(full + stage, kGemmStageBytes);
          load_slice<kMajorA, kMajorW>(a_s, a_s + kGemmATile, &a_map, &w_map, kt * kGemmBK, m0,
                                       n0, full + stage);
          if (++stage == kGemmStages) {
            stage = 0;
            round ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int half = warpgroup - 1;  // rows 64 half .. 64 half + 63 of the tile
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const bool leader = (threadIdx.x & 127) == 0;
    unsigned char* staging = gemm_smem + kGemmRingBytes + half * kGemmOutTile;
    int stage = 0;
    uint32_t round = 0;
    uint32_t aux_round = 0;
    float d[kGemmAcc];
    for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
      const int tile = kSplit ? unit % tiles : unit;
      const int m0 = tile / n_tiles * kGemmBM;
      const int n0 = tile % n_tiles * kGemmBN;
      const int kt0 = kSplit ? unit / tiles * split_slices : 0;
      const int kt1 = kSplit ? min(slices, kt0 + split_slices) : slices;
      const int row0 = m0 + half * 64;
      int held = 0;  // the slot whose products are in flight
      fence_accumulators(d);
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(full + stage, round);
        const unsigned char* a_s = gemm_smem + stage * kGemmStageBytes;
        // The warpgroup's 64 rows of A: the second half of a K-major tile,
        // the second box of an MN-major one, 8 KB in either form.
        const uint64_t desc_a = operand_desc<kMajorA>(a_s + half * kGemmBoxBytes);
        const uint64_t desc_w = operand_desc<kMajorW>(a_s + kGemmATile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGemmBK / 16; ++kk) {
          wgmma_m64n192k16<kMajorA == Major::kMN, kMajorW == Major::kMN>(
              d, desc_a + kDescStep<kMajorA> * kk, desc_w + kDescStep<kMajorW> * kk,
              kt > kt0 || kk > 0);
        }
        wgmma_commit();
        if (kt > kt0) {  // the slice before has been read: release its slot
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + held);
        }
        if constexpr (Epilogue::kAux == Aux::kResidual) {
          // The residual tile into the staging tile while the products run,
          // once the last tile's stores have read it: two slices in, so that
          // waiting for those reads rarely holds up this warp's products.
          if (kt == (slices > 2 ? 2 : slices - 1) && leader) {
            bulk_wait_read();
            mbar_arrive_expect(aux_full + half, kGemmOutTile);
#pragma unroll
            for (int box = 0; box < kGemmBN / kGemmBox; ++box) {
              tma_load_2d(staging + box * kGemmBoxBytes, &aux_map, n0 + box * kGemmBox, row0,
                          aux_full + half);
            }
          }
        }
        held = stage;
        if (++stage == kGemmStages) {
          stage = 0;
          round ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_accumulators(d);
      if (lane == 0) mbar_arrive(empty + held);

      const int r0 = warp * 16 + (lane >> 2);
      if constexpr (Epilogue::kAux == Aux::kF32) {  // the split's own partial
        store_f32_pairs(out_f32 + static_cast<size_t>(unit / tiles) * M * N, d, row0 + r0, n0, M,
                        N, lane);
      } else {
        if constexpr (Epilogue::kAux == Aux::kResidual) {
          mbar_wait(aux_full + half, aux_round);
          aux_round ^= 1;
        } else {
          if (leader) bulk_wait_read();  // the last tile's stores have read the staging tile
          warpgroup_sync(half);
        }
        if constexpr (Epilogue::kAux == Aux::kHidden) {
          stage_pairs<Epilogue, true>(staging, d, bias, n0, N, r0, lane);
          store_staged(staging, &aux_map, n0, row0, half, leader);
          if (leader) bulk_wait_read();
          warpgroup_sync(half);
        }
        stage_pairs<Epilogue, false>(staging, d, bias, n0, N, r0, lane);
        store_staged(staging, &out_map, n0, row0, half, leader);
      }
    }
    if (leader) bulk_wait_read();  // the shared memory outlives the last stores' reads
  }
}

// A 2-d tensor map over a row-major (rows, cols) bf16 matrix, its box 64
// columns (128 bytes, the swizzle span) x box_rows rows, 128-byte swizzled,
// out-of-range elements read as zero and never written.
inline cudaError_t gemm_tensor_map(CUtensorMap* map, const bf16* base, int rows, int cols,
                                   int box_rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kGemmBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of an operand: K-major (rows, K) with boxes of 64 K x `rows`
// rows of the tile, or MN-major (K, rows) with boxes of 64 x 64.
template <Major kMajor>
cudaError_t operand_tensor_map(CUtensorMap* map, const bf16* base, int rows, int K,
                               int tile_rows) {
  return kMajor == Major::kK ? gemm_tensor_map(map, base, rows, K, tile_rows)
                             : gemm_tensor_map(map, base, K, rows, kGemmBox);
}

// out = epilogue(A W^T + bias) on `st`: A (M, K) [MN-major: stored (K, M)], W
// (N, K) [MN-major: stored (K, N)], out (M, N); the contiguous dimension of
// each a multiple of 8.  `aux` is the residual (M, N) for Aux::kResidual, the
// hidden output (M, N) for Aux::kHidden, else unused.  Aux::kF32 writes no
// `out`: split s of K (rows s * split_rows .., split_rows a multiple of 64, 0
// for one split) stores its f32 sums to out_f32 + s * M * N.
template <class Epilogue, Major kMajorA = Major::kK, Major kMajorW = Major::kK>
cudaError_t launch_gemm_sm90(const bf16* A, const bf16* W, const float* bias, bf16* out,
                             const bf16* aux, int M, int N, int K, cudaStream_t st,
                             float* out_f32 = nullptr, int split_rows = 0) {
  auto kernel = gemm_sm90_kernel<Epilogue, kMajorA, kMajorW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kGemmSmemBytes);
  if (err != cudaSuccess) return err;
  CUtensorMap a_map, w_map, out_map{}, aux_map{};
  err = operand_tensor_map<kMajorA>(&a_map, A, M, K, kGemmBM);
  if (err != cudaSuccess) return err;
  err = operand_tensor_map<kMajorW>(&w_map, W, N, K, kGemmBN);
  if (err != cudaSuccess) return err;
  if constexpr (Epilogue::kAux != Aux::kF32) {
    err = gemm_tensor_map(&out_map, out, M, N, kGemmBox);
    if (err != cudaSuccess) return err;
    err = gemm_tensor_map(&aux_map, Epilogue::kAux == Aux::kNone ? out : aux, M, N, kGemmBox);
    if (err != cudaSuccess) return err;
  }
  const int slices = (K + kGemmBK - 1) / kGemmBK;
  const int split_slices = split_rows == 0 ? slices : split_rows / kGemmBK;
  const int tiles = (M + kGemmBM - 1) / kGemmBM * ((N + kGemmBN - 1) / kGemmBN);
  int grid = 0;
  err = persistent_grid(tiles * ((slices + split_slices - 1) / split_slices), &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGemmThreads, kGemmSmemBytes, st>>>(a_map, w_map, out_map, aux_map, bias,
                                                      out_f32, M, N, K, split_slices);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2
