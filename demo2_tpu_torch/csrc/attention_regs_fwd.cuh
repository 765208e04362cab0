// The register-resident attention forward: the second design of the attention
// forward tile.  Two kernels are instantiated from it, one per rounding mode:
//   Softmax::kF32         flash_attention.cu, kernel 9: replaces the Pallas
//       kernel demo2_tpu/ops/flash_attention.py::_fwd_kernel.  p stays f32 for
//       the PV product (a bf16 hi / lo split, two tensor-core products into one
//       f32 accumulator: p = hi + lo leaves at most 2^-18 |p| out);
//   Softmax::kNormAfterPV packed_attention.cu, kernel 5: replaces
//       demo2_tpu/ops/packed_attention.py::_fwd_kernel.  The UNnormalised exp
//       is rounded to bf16 once for the PV product and the f32 result is
//       multiplied by 1 / (sum + 1e-30), where sum adds the unrounded exps.
// Softmax::kNormBeforePV (kernels 1 and 3) and the ablation tool (kernel 13)
// stay on the first design, attention_fwd.cuh.  Per (sample, head),
//   o = softmax(q k^T * scale) v,
// with the scores in f32.
//
// What bounds the work on an H100: at 192 samples x 129 rows x 12 heads of 64
// the kernel must move 152 MB (0.045 ms at 3.35 TB/s) and counts 9.8 GFLOP;
// with the split it executes 18.3 GFLOP, 0.02 ms at the tensor cores' peak,
// without it 12.2.  So bytes bound it, and the first design (attention_fwd.cuh)
// missed that bound by 7-8x because it read every head's K and V nine times and
// passed scores and probabilities through shared memory between barriers.
//
// The design:
//   * A (sample, head) is an item: its Q, K and V (<= 144 x 64 bf16 each) are
//     read from device memory once, each by one TMA tile copy (a 4-d tensor
//     map over the strided view the HeadLayout describes: (B, S, H, D), or the
//     three C-wide column blocks of the packed (B, S, 3C) qkv; rows >= S
//     zero-filled by the copy engine) into a ring of four items in shared
//     memory.  Rows are 128 bytes with the TMA's 128-byte swizzle, which
//     ldmatrix addresses undo, so fragment loads are free of bank conflicts
//     without padding.
//   * A task is 16 query rows of an item against all its S16 keys, done by one
//     warp.  The 16 x 144 f32 scores are 72 registers a thread (mma.sync
//     m16n8k16 accumulators); the row maximum and sum are two quad shuffles
//     each; the accumulator layout of the scores is the A-operand layout of
//     the next product, so p is rounded (or split into hi and lo) in registers
//     and feeds PV directly (V through ldmatrix.trans).  Scores and
//     probabilities never touch shared memory.  O (16 x 64, 32 registers) is
//     rounded once and staged through the task's own Q rows, which no other
//     task reads, for 16-byte stores.
//   * The grid is persistent (one 512-thread block an SM) and inside a block
//     the tasks of its items form one stream that the sixteen warps take in
//     turn.  No block barrier exists after the start: a warp waits on an
//     item's `full` mbarrier (the TMA's completion), and arrives on its
//     `empty` one; the warp that takes an item's first task asks for the item
//     three ahead.  So the warps drift apart, and QK^T (tensor cores), softmax
//     (ALU and the special-function unit) and PV of different tasks overlap on
//     each of the SM's four sub-cores, four warps on each.
// Measured on the way (H100, kF32 at (192, 129, 12, 64)): with one block
// barrier pair per item and nine warps in lockstep the kernel took 0.147 ms,
// 40% of it in the softmax, which every warp reached at the same time; the
// task stream with the same arithmetic computes in 0.077 ms.  Loading rows by
// 128-byte bulk copies (387 an item) held the stream to 0.173 ms: the copy
// engine wants few large requests, hence the tensor map.  Warps a block, with
// the registers that leaves a thread: 8 (168 used) 0.129 ms, 10 0.127, 12
// (168) 0.107, 16 (128, no spills) 0.097, 18 (96: 780 bytes of spill stores)
// 0.204.  More warps hide more of each other's latencies until the scores
// spill.  mma.sync with 16-row tasks was chosen over wgmma's 64-row tiles: 129
// rows fill nine 16-row tiles to 90% and three 64-row tiles to 67%, the scores
// of a 64 x 144 tile would not fit a warpgroup's registers beside O with the
// split, and the bound is bytes, not operations.
//
// Arithmetic: the scale multiplies the f32 scores (the Pallas kernels scale q
// before the product or the scores after it: the same value for the
// power-of-two scale of 64-wide heads), folded with log2(e) into one factor c;
// exp is ex2.approx on fma(s, c, -max(s) c) and the normalisation multiplies
// by 1 / (sum + 1e-30).  Both stay within f32 rounding noise of the plain
// version (~1e-6 relative in p), far inside the bf16 bounds the kernels are
// held to.
//
// kNormAfterPV on the packed qkv (192, 129, 2304), probed once with the warp
// count as a build option: 8 warps 0.115 ms, 12 0.090, 14 0.088, 16 0.081,
// 20 (96 registers, 604 bytes of spill stores) 0.156: sixteen for both modes.
//
// Resources (nvcc 12.9, -Xptxas -v, sm_90a), both 221,264 bytes of dynamic
// shared memory, one block of sixteen warps on an SM: kF32 128 registers (the
// cap of four warps a sub-core), kNormAfterPV 127, neither spills.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up at run time
#include <dlfcn.h>

#include "attention_fwd.cuh"
#include "gemm.cuh"

namespace demo2 {
namespace {

constexpr int kRegsTiles = kMaxSeq / 16;          // 16-row tasks of one head: 9
constexpr int kRegsWarps = 16;                    // the forward: four warps on each sub-core
constexpr int kRegsThreads = kRegsWarps * 32;     // 512
constexpr int kRegsTile = kMaxSeq * kHeadDim;     // one operand of one head, 128-byte rows
constexpr int kRegsCols8 = kMaxSeq / 8;           // 8-wide column tiles of a score row: 18
constexpr int kRegsDim8 = kHeadDim / 8;           // 8-wide column tiles of an output row: 8
constexpr int kRegsRowBytes = kHeadDim * static_cast<int>(sizeof(bf16));
constexpr int kRegsFwdRing = 4;                   // items of Q, K, V in shared memory
constexpr int kRegsFwdSmemBytes =
    kRegsFwdRing * 3 * kRegsTile * static_cast<int>(sizeof(bf16)) + 2 * kRegsFwdRing * 8 +
    kRegsFwdRing * 4;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kHeadDim == 64 && kMaxSeq % 16 == 0, "the register tiling is written for 64-wide heads");
static_assert(kRegsRowBytes == 128, "a row is one 128-byte swizzle span");
static_assert((kRegsTile * sizeof(bf16)) % 1024 == 0, "swizzled tiles start on 1024 bytes");
static_assert(kRegsFwdSmemBytes <= 232448, "the ring of Q, K, V must fit one SM");

// ---- fragments ---------------------------------------------------------------

// Element (r, 8 c) of a tile of 128-byte rows under the 128-byte swizzle: the
// 16-byte chunk c of row r lies at chunk c ^ (r % 8).  The tile starts on a
// multiple of 1024 bytes (TMA tiles) or is only ever addressed through here.
__device__ __forceinline__ bf16* swizzled(bf16* tile, int r, int c) {
  return tile + r * kHeadDim + ((c ^ (r & 7)) << 3);
}
__device__ __forceinline__ const bf16* swizzled(const bf16* tile, int r, int c) {
  return tile + r * kHeadDim + ((c ^ (r & 7)) << 3);
}

// ldmatrix with .trans: four 8 x 8 b16 matrices, each delivered transposed, so
// a row-major [k][n] operand in shared memory gives the mma's B fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// mma_16816 of gemm.cuh without `volatile`: a pure function of its operands,
// so the compiler may interleave independent accumulator chains.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as one register of two bf16 (x in the low half), and what
// the rounding left out as a second one: x = hi + lo up to 2^-18 |x|.
__device__ __forceinline__ uint32_t pack_bf16x2(float x, float y) {
  return bf16_bits(x) | (bf16_bits(y) << 16);
}
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const bf16 xh = __float2bfloat16_rn(x);
  const bf16 yh = __float2bfloat16_rn(y);
  hi = static_cast<uint32_t>(__bfloat16_as_ushort(xh)) |
       (static_cast<uint32_t>(__bfloat16_as_ushort(yh)) << 16);
  lo = pack_bf16x2(x - __bfloat162float(xh), y - __bfloat162float(yh));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers and TMA tile copies (the ring of items in shared memory) ------

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
// A parity wait tells two phases of an mbarrier apart, no more: asked for a
// phase two ahead of the barrier's it returns at once.  A warp's consecutive
// tasks can lie several items apart (sixteen, where an item is one task), so
// beside each slot's barriers stands the block's index of the last item whose
// load into it was started.  wait_started(started + slot, i) returns once item
// i's load was started: the slot's `full` barrier is then in item i's phase
// and its `empty` barrier in the phase of the item before it, and a parity
// wait on either is exact.  The task that starts the load is an earlier one of
// the stream, so this wait forms no cycle either.  (Without it (192, 16, 12,
// 64), seventeen one-task items a block, ended in a launch failure, as did
// builds with 20 or more warps at 129 rows.)
__device__ __forceinline__ void wait_started(const volatile int* started, int i) {
  while (*started < i) {
  }
}
// All rows of head h of sample b (the map's box: S16 rows x 64, rows >= S
// zero) to the swizzled tile at dst; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_head(bf16* dst, const CUtensorMap* map, int h, int b,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(0), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// A 4-d tensor map (d, head, row, sample) over a head-split bf16 tensor, its
// box all S16 rows of one head of one sample, 128-byte swizzled.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t head_tensor_map(CUtensorMap* map, const bf16* base, HeadLayout l, int batch,
                                   int seq, int heads) {
  // libcuda's encoder, looked up in the loaded libcuda at the first call, so
  // that the library itself links the CUDA runtime only.
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    void* fn = libcuda != nullptr ? dlsym(libcuda, "cuTensorMapEncodeTiled") : nullptr;
    if (fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHeadDim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(l.head) * sizeof(bf16),
                                 static_cast<cuuint64_t>(l.row) * sizeof(bf16),
                                 static_cast<cuuint64_t>(l.sample) * sizeof(bf16)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kHeadDim), 1,
                             static_cast<cuuint32_t>((seq + 15) & ~15), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                              const_cast<bf16*>(base), dims, strides, box, step,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- the products ------------------------------------------------------------

// acc (16 x S16, the warp's accumulator layout: acc[nt][0..1] at row lane/4,
// columns 8 nt + 2 (lane % 4) + {0, 1}; [2..3] eight rows down) = A B^T with
// A rows a_row0 .. a_row0 + 15 of the swizzled tile `a` and B the S16 rows of
// the swizzled tile `b`, both [r][d] bf16.  `pairs` = S16 / 16 (warp-uniform).
__device__ __forceinline__ void product_rows(float (&acc)[kRegsCols8][4], const bf16* a,
                                             int a_row0, const bf16* b, int pairs, int lane) {
#pragma unroll
  for (int nt = 0; nt < kRegsCols8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // The 16-wide slice of d outermost: four A registers live at a time, and
  // 2 x pairs independent accumulator chains between two uses of one.
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    uint32_t fa[4];
    ldmatrix_x4(fa, swizzled(a, a_row0 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < kRegsTiles; ++np) {
      if (np < pairs) {
        uint32_t fb[4];
        ldmatrix_x4(fb, swizzled(b, np * 16 + ((lane >> 4) << 3) + (lane & 7),
                                 kk * 2 + ((lane >> 3) & 1)));
        mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
        mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

// out (16 x 64, the same layout) += X B with X the warp's 16 x S16 f32 values
// in registers (the layout product_rows leaves: it is the A-operand layout)
// and B the S16 rows of the swizzled tile `b`, [k][d] bf16.  kSplit: X as
// hi + lo, two products; else X rounded to bf16 once.
template <bool kSplit>
__device__ __forceinline__ void product_regs(float (&out)[kRegsDim8][4],
                                             const float (&x)[kRegsCols8][4], const bf16* b,
                                             int pairs, int lane) {
#pragma unroll
  for (int j = 0; j < kRegsTiles; ++j) {
    if (j < pairs) {
      uint32_t hi[4], lo[4];
      if (kSplit) {
        split_bf16x2(x[2 * j][0], x[2 * j][1], hi[0], lo[0]);
        split_bf16x2(x[2 * j][2], x[2 * j][3], hi[1], lo[1]);
        split_bf16x2(x[2 * j + 1][0], x[2 * j + 1][1], hi[2], lo[2]);
        split_bf16x2(x[2 * j + 1][2], x[2 * j + 1][3], hi[3], lo[3]);
      } else {
        hi[0] = pack_bf16x2(x[2 * j][0], x[2 * j][1]);
        hi[1] = pack_bf16x2(x[2 * j][2], x[2 * j][3]);
        hi[2] = pack_bf16x2(x[2 * j + 1][0], x[2 * j + 1][1]);
        hi[3] = pack_bf16x2(x[2 * j + 1][2], x[2 * j + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < kRegsDim8 / 2; ++dp) {
        uint32_t fb[4];  // keys 0-7 / 8-15 of the step at d 0-7, then at d 8-15
        ldmatrix_x4_trans(fb, swizzled(b, j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                       dp * 2 + (lane >> 4)));
        mma_bf16(out[2 * dp], hi, fb[0], fb[1]);
        mma_bf16(out[2 * dp + 1], hi, fb[2], fb[3]);
        if (kSplit) {
          mma_bf16(out[2 * dp], lo, fb[0], fb[1]);
          mma_bf16(out[2 * dp + 1], lo, fb[2], fb[3]);
        }
      }
    }
  }
}

// The row softmax of the warp's 16 x S16 raw scores, in registers, with
// c = scale * log2(e) > 0: on return s holds exp2(fma(s, c, -m)) [* rinv when
// kNormalise], 0 in columns >= keys; m0 / m1 are max(s) * c of rows lane/4 and
// lane/4 + 8, rinv0 / rinv1 = 1 / (sum + 1e-30) of their exps.  Whoever holds
// a raw score, m and rinv of its row gets the same p from the same expression,
// bit for bit: the backward's two kinds of task do.
template <bool kNormalise>
__device__ __forceinline__ void softmax_rows(float (&s)[kRegsCols8][4], int pairs, int keys,
                                             float c, int lane, float& m0, float& m1,
                                             float& rinv0, float& rinv1) {
  const int tq = lane & 3;
  m0 = -INFINITY;
  m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kRegsCols8; ++nt) {
    if (nt < 2 * pairs) {
      if (nt * 8 + 8 > keys) {  // only the last tiles hold columns >= keys
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + 2 * tq + (e & 1) >= keys) s[nt][e] = -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
  m0 = quad_max(m0) * c;
  m1 = quad_max(m1) * c;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kRegsCols8; ++nt) {
    if (nt < 2 * pairs) {
      s[nt][0] = exp2_approx(fmaf(s[nt][0], c, -m0));
      s[nt][1] = exp2_approx(fmaf(s[nt][1], c, -m0));
      s[nt][2] = exp2_approx(fmaf(s[nt][2], c, -m1));
      s[nt][3] = exp2_approx(fmaf(s[nt][3], c, -m1));
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
  }
  rinv0 = 1.f / (quad_sum(sum0) + 1e-30f);
  rinv1 = 1.f / (quad_sum(sum1) + 1e-30f);
  if (kNormalise) {
#pragma unroll
    for (int nt = 0; nt < kRegsCols8; ++nt) {
      if (nt < 2 * pairs) {
        s[nt][0] *= rinv0;
        s[nt][1] *= rinv0;
        s[nt][2] *= rinv1;
        s[nt][3] *= rinv1;
      }
    }
  }
}

// The warp's 16 x 64 f32 tile (accumulator layout), times `mul`, rounded to
// bf16 once, through the 16 swizzled rows at `stage` (the warp's own, starting
// on a multiple of 8 rows) to rows row0 .. row0 + 15 < S of dst (row stride
// `row`): 16 bytes a thread.
__device__ __forceinline__ void store_tile(const float (&o)[kRegsDim8][4], float mul, bf16* stage,
                                           bf16* dst, int row, int row0, int S, int lane) {
  const int g = lane >> 2;
  const int tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < kRegsDim8; ++nt) {
    *reinterpret_cast<uint32_t*>(swizzled(stage, g, nt) + 2 * tq) =
        pack_bf16x2(o[nt][0] * mul, o[nt][1] * mul);
    *reinterpret_cast<uint32_t*>(swizzled(stage, g + 8, nt) + 2 * tq) =
        pack_bf16x2(o[nt][2] * mul, o[nt][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3;
    if (row0 + r < S) {
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * row + (i & 7) * 8) =
          *reinterpret_cast<const uint4*>(swizzled(stage, r, i & 7));
    }
  }
}

// ---- the kernel ----------------------------------------------------------------

// Items of this block (block i takes items i, i + gridDim.x, ... of the
// batch * heads (sample, head) pairs).
__device__ __forceinline__ int block_items(int items) {
  return blockIdx.x < items ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
}

// Persistent, and a stream of tasks inside the block: task u is tile u %
// pairs of the block's item u / pairs, and warp w takes tasks w, w + 16, ...
// `keys` <= S is the number of valid keys.
template <Softmax kMode>
__global__ void __launch_bounds__(kRegsThreads, 1)
attention_regs_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                          HeadLayout ol, int S, int keys, int heads, int items, float scale) {
  static_assert(kMode != Softmax::kNormBeforePV, "kernels 1 and 3 stay on attention_fwd.cuh");
  constexpr bool kSplit = kMode == Softmax::kF32;
  constexpr bool kNormFirst = kMode != Softmax::kNormAfterPV;
  extern __shared__ __align__(1024) unsigned char regs_fwd_smem[];
  bf16* smem = reinterpret_cast<bf16*>(regs_fwd_smem);  // kRegsFwdRing x [Q | K | V]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRegsFwdRing * 3 * kRegsTile);
  uint64_t* empty = full + kRegsFwdRing;
  volatile int* started = reinterpret_cast<volatile int*>(empty + kRegsFwdRing);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s_pad = (S + 15) & ~15;
  const int pairs = s_pad / 16;
  const int mine = block_items(items);
  const float c = scale * kLog2e;

  if (threadIdx.x == 0) {
    for (int b = 0; b < kRegsFwdRing; ++b) {
      mbar_init(full + b, 1);
      mbar_init(empty + b, pairs);  // one arrival per task of the item
      started[b] = -1;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int i) {  // one lane: the block's i-th item into slot i % kRegsFwdRing
    const int item = blockIdx.x + i * gridDim.x;
    const int slot = i % kRegsFwdRing;
    bf16* dst = smem + slot * 3 * kRegsTile;
    mbar_arrive_expect(full + slot, static_cast<uint32_t>(3 * s_pad * kRegsRowBytes));
    tma_load_head(dst, &q_map, item % heads, item / heads, full + slot);
    tma_load_head(dst + kRegsTile, &k_map, item % heads, item / heads, full + slot);
    tma_load_head(dst + 2 * kRegsTile, &v_map, item % heads, item / heads, full + slot);
    started[slot] = i;
  };
  if (warp == 0 && lane == 0) {
    for (int i = 0; i < kRegsFwdRing - 1 && i < mine; ++i) load(i);
  }

  for (int u = warp; u < mine * pairs; u += kRegsWarps) {
    const int i = u / pairs;
    const int tile = u - i * pairs;
    const int slot = i % kRegsFwdRing;
    const int item = blockIdx.x + i * gridDim.x;
    wait_started(started + slot, i);
    mbar_wait(full + slot, (i / kRegsFwdRing) & 1);
    {
      bf16* q_s = smem + slot * 3 * kRegsTile;
      const bf16* k_s = q_s + kRegsTile;
      const bf16* v_s = k_s + kRegsTile;
      float s[kRegsCols8][4];
      product_rows(s, q_s, tile * 16, k_s, pairs, lane);
      float m0, m1, rinv0, rinv1;
      softmax_rows<kNormFirst>(s, pairs, keys, c, lane, m0, m1, rinv0, rinv1);
      float o[kRegsDim8][4];
#pragma unroll
      for (int nt = 0; nt < kRegsDim8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
      product_regs<kSplit>(o, s, v_s, pairs, lane);
      if (!kNormFirst) {  // the unnormalised exp went through PV: normalise now
#pragma unroll
        for (int nt = 0; nt < kRegsDim8; ++nt) {
          o[nt][0] *= rinv0;
          o[nt][1] *= rinv0;
          o[nt][2] *= rinv1;
          o[nt][3] *= rinv1;
        }
      }
      // Staged through the task's own Q rows, which no other task reads.
      store_tile(o, 1.f, q_s + tile * 16 * kHeadDim, out + ol.at(item / heads, item % heads),
                 ol.row, tile * 16, S, lane);
    }
    fence_async_proxy();  // the staging stores, before a TMA copy reuses the slot
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty + slot);
      // The warp that took an item's first task asks for the item three
      // ahead, into the slot of the item before this one, once that is consumed.
      const int ahead = i + kRegsFwdRing - 1;
      if (tile == 0 && ahead < mine) {
        if (ahead >= kRegsFwdRing) {
          wait_started(started + ahead % kRegsFwdRing, ahead - kRegsFwdRing);
          mbar_wait(empty + ahead % kRegsFwdRing, (ahead / kRegsFwdRing - 1) & 1);
        }
        load(ahead);
      }
    }
    __syncwarp();
  }
}

// One block an SM of the current device, or one an item where those are fewer.
inline cudaError_t regs_grid(int items, int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *grid = items < sms ? items : sms;
  return cudaSuccess;
}

template <Softmax kMode>
cudaError_t launch_attention_regs_fwd(const bf16* q, const bf16* k, const bf16* v, HeadLayout in,
                                      bf16* out, HeadLayout ol, int batch, int seq, int heads,
                                      float scale, cudaStream_t st, int keys = -1) {
  auto kernel = attention_regs_fwd_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kRegsFwdSmemBytes);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = regs_grid(batch * heads, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3];
  const bf16* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    err = head_tensor_map(&maps[i], bases[i], in, batch, seq, heads);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kRegsThreads, kRegsFwdSmemBytes, st>>>(maps[0], maps[1], maps[2], out, ol, seq,
                                                         keys < 0 ? seq : keys, heads,
                                                         batch * heads, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2
