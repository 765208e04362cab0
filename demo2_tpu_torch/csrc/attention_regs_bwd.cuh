// The register-resident attention backward: the second design of the attention
// backward.  Four kernels are instantiated from it, one per Probs mode:
//   Probs::kRecomputeF32  flash_attention.cu, kernel 10: replaces the Pallas
//       kernel demo2_tpu/ops/flash_attention.py::_bwd_kernel.  f32 throughout:
//       P and dS enter their products as a bf16 hi / lo split (two tensor-core
//       products into one f32 accumulator);
//   Probs::kRecompute     packed_attention.cu, kernel 6: replaces
//       demo2_tpu/ops/packed_attention.py::_bwd_kernel.  P is normalised in
//       f32; dV takes bf16(P), dS is computed from the f32 P and rounded to
//       bf16 once for the dQ and dK products;
//   Probs::kSaved         attention_bwd.cu, kernels 4 (kDb) and 7: replace
//       demo2_tpu/ops/packed_attention.py::_bwd_saved_db_kernel and
//       ::_bwd_saved_kernel.  P is the forward's saved bf16 p, read from
//       probs (B, H, S, S16); dS is computed in f32 from that bf16 P and
//       rounded to bf16 once; with kDb the f32 column sums of the rounded dq,
//       dk, dv go to db_partial (B, 3C).
// Kernel 8 (attention_bwd.cu, demo2_attention_bwd_fused_dw) runs kernel 4's
// instantiation, then contracts its dqkv on gemm_sm90.cuh.  Per (sample,
// head), from bf16 q, k, v and dO,
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - rowsum(dP * P))  (from dP and
//   P, not through dO . O);  dQ = dS K * scale;  dK = dS^T Q * scale,
// the outputs rounded to bf16 once.
//
// What bounds the work on an H100: at 192 samples x 129 rows x 12 heads of 64
// the recomputing kernels must move 266 MB (0.080 ms at 3.35 TB/s) and count
// 24.5 GFLOP; the saved-probs kernels also read 86 MB of P (352 MB, 0.105 ms)
// and count 19.6 GFLOP.  The first design (a shared-memory header, deleted
// since) took 10-17x that: one block per SM walked nine query tiles with five
// or six block
// barriers each, kept the dK / dV accumulators in shared memory (72 tiles
// loaded and stored per query tile) and passed S, P, dP and dS through shared
// memory.
//
// The design: a (sample, head) is an item; its Q, K, V and dO (<= 144 x 64
// bf16 each) are read from device memory once, each by one TMA tile copy into
// a ring of two items in shared memory (128-byte swizzled rows, as
// attention_regs_fwd.cuh, whose fragments, products, softmax and mbarrier
// helpers this file uses).  dQ, dK and dV leave as 4-byte stores straight
// from the accumulator layout (a quad writes 16 consecutive bytes).  An item
// is two kinds of 16-row task, each done by one warp with everything between
// its products in registers; no accumulator lives in shared memory and there
// are no atomics:
//   * Query-owner task: query rows 16t .. 16t + 15.  S = Q_t K^T and dP =
//     dO_t V^T (16 x 144 f32 each) live in registers; the row maximum m,
//     1 / (sum + 1e-30) and delta = rowsum(dP * P) come from quad shuffles and
//     are left in shared memory (3 x 144 floats an item); dS, in the registers
//     of dP, is the A operand of dQ_t = dS K, which is complete for these rows
//     and is written at once.
//   * Key-owner task: keys 16t .. 16t + 15.  S^T = K_t Q^T and dP^T = V_t dO^T
//     in registers; P^T = exp(S^T * scale - m) / (sum + 1e-30) and dS^T =
//     P^T (dP^T - delta) from the per-query statistics; dV_t = P^T dO and
//     dK_t = dS^T Q contract over the 144 queries into 32 registers each and
//     are written once.
// The grid is persistent (one block an SM) and the tasks of a block's items,
// each item's query-owner tasks and then its key-owner tasks, form one stream
// that the warps take in turn.  No block barrier exists after the start: a
// task waits on the item's `full` mbarrier (the TMA's completion), a key-owner
// task also on its `ready` one (nine arrivals, the query-owner tasks'
// statistics), and arrives on `empty`; the warp that took an item's first task
// asks for the next item once the one before is consumed.
// The recomputing modes run QK^T and dO V^T twice (ten 144 x 144 x 64 products
// with the split where the first design ran eight: ~61 GFLOP executed, 0.06 ms
// at the tensor cores' peak; seven without the split, ~43 GFLOP) and buy: no
// load / store of 72 accumulator tiles on each of nine query tiles, no block
// barrier in place of 54 an item, every warp busy, tensor-core, ALU and
// special-function work of different tasks overlapping, and a fixed summation
// order: reruns are bit-identical.  Row statistics from the forward are not
// taken: the VJP's residuals are q, k and v only.
// Both kinds of task compute P from the same raw score, maximum and 1 / sum by
// the same expression (softmax_rows, attention_regs_fwd.cuh) and dS from the
// same dP and delta, so dQ and dK are products of one dS, rounded or split
// alike.
//
// Probs::kSaved.  The item's P comes in beside Q, K, V and dO: rows < S of the
// (S, S16) bf16 matrix are contiguous in probs, so one bulk copy (no tensor
// map) brings them into the slot's P tile, rows of S16 bf16 as in device
// memory; its rows >= S are zeroed once at the start and never written again.
// Neither kind of task computes a score or an exponential, and only delta
// passes between them:
//   * Query-owner: an ldmatrix 8 x 8 block has its pairs where the m16n8
//     accumulator has them, so P rows 16t .. 16t + 15 are read straight into
//     the layout of dP (36 registers of bf16 pairs); dP = dO_t V^T; delta by
//     quad shuffles; dS in dP's registers, rounded once by product_regs; dQ.
//   * Key-owner: P^T for keys 16t .. 16t + 15 by ldmatrix.trans from the same
//     tile is the A operand of dV_t = P^T dO as it stands; dP^T = V_t dO^T;
//     only then the wait on `ready`, for delta; dS^T = P^T (dP^T - delta),
//     rounded once; dK_t.  Five products an item where kRecompute runs seven.
// Two slots of Q, K, V, dO (73,728 bytes) and P (41,472) are 230,400 bytes of
// the SM's 232,448: the kernel takes 232,380.  A 128-byte swizzled P tile
// (three TMA boxes of 64, 64 and 16 columns, each padded to 128-byte rows)
// would be 55,296 bytes a slot and two slots would not fit, so the tile is
// unswizzled: with 288-byte rows the eight rows of an ldmatrix block fall on
// four 16-byte bank groups, two rows each, a 2-way conflict on the 9 P loads
// of a task among its ~85 (query-owner) or ~120 (key-owner) fragment loads.
// db (kDb): each task owns a 16 x 64 tile of dq, or of dk and of dv.  The tile
// is rounded to bf16 pairs once (one conversion a pair), for the store and the
// sums both; the column sums over the eight row groups come from a
// transposing shuffle tree (14 shuffles a tile, lane l ends with columns 2l
// and 2l + 1).  Tasks finish in any order, so the sums are added in the order
// of the stream: a counter in shared memory names the task whose turn it is;
// at its end (after its `empty` arrival or its request for the next item, so
// that neither waits for a turn) a task waits for the counter to reach it,
// adds its 64 (or 2 x 64) sums to the block's accumulator (3 x 64 floats), or
// as an item's last task of its kind writes the total to db_partial[sample,
// section, head's 64 columns] instead, and passes the turn on.  A task only
// ever waits for an earlier task of the stream, so no wait can form a cycle.
// attention_bwd.cu adds the samples in a fixed order: db is bit-identical
// over reruns.  (Nine 64-float rows a section and slot, added by the last
// arriver, would need 13,824 bytes that the two slots leave no room for; a
// (B, tasks, 3C) scratch in device memory would write and read 15.9 MB at
// batch 192.)
//
// Measured on the way (H100, kSaved with db at qkv (192, 129, 2304), six turns
// of 20 launches each, all builds bit-equal).  Holding a task's P fragments in
// registers (36) from the first use to the second, warps a block with the
// registers that leaves a thread: 8 (226 used, no spills) 0.258 ms, 10 (168:
// 172 bytes of spill stores) 0.391, 12 (168) 0.369, 14 (128: 312 bytes) 0.402,
// 16 (128) 0.365: whatever spills loses.  Reading the fragments again where
// they are used again (9 more ldmatrix a task): 8 (153) 0.257 ms, 10 (155)
// 0.239, 12 (155, no spills) 0.227, 14 (128: 44 bytes) 0.307, 16 (128) 0.276:
// twelve, as the recomputing modes.  Of kernel 4's 0.206 ms in this kernel
// (0.211 with the pass that adds the samples) the db sums are 0.020 (kernel 7:
// 0.186): with two conversions a value of their own they were 0.035; the wait
// for the turn is not what costs (a build that never waits reads the same; one
// that carries the sums through the warp's next task and adds them after it,
// so that the turn has always come, reads 0.213 at 162 registers); the fences
// are 0.003.  The first design takes 1.01 ms: 4.7x.
//
// Measured on the way (H100, kRecomputeF32 at (192, 129, 12, 64)): nine warps
// in lockstep with two block barriers an item took 0.452 ms; the task stream
// 0.344 ms with the
// outputs staged through a shared-memory tile per warp for 16-byte stores, and
// 0.289 ms with the direct stores (in the forward the two ways to store read
// the same, and it stages through rows it owns anyway).  A ring of three with
// item k's query-owner tasks ahead of item k - 1's key-owner tasks, so that no
// key-owner task waits for statistics, read 0.440 ms and was dropped.  Warps a
// block, with the registers that leaves a thread: 8 (254 used, no spills)
// 0.343 ms, 10 (168) 0.359, 12 (168) 0.288, 14 (128: 1,344 bytes of spill
// stores) 0.498.  A task holds two 16 x 144 f32 tiles (144 registers) beside
// a 32-register accumulator and the fragments, so twelve warps spill a little
// and still win: the warps hide each other's latencies.
//
// Query rows >= S have zero q and dO: the query-owner task leaves them
// 1 / sum = 0, so their P^T and dS^T columns are exactly zero afterwards.
//
// kRecompute on the packed qkv (192, 129, 2304), probed once with the warp
// count as a build option: 8 warps (254 registers, no spills) 0.284 ms, 10
// 0.283, 12 0.249, 14 (128 registers, 1,360 bytes of spill stores) 0.433, 16
// 0.446: the two 72-register tiles decide, split or not, so twelve for both.
//
// Resources (nvcc 12.9, -Xptxas -v, sm_90a), one block on an SM: kRecomputeF32
// and kRecompute alike use twelve warps, 150,968 bytes of dynamic shared
// memory and 168 registers (the cap of three warps a sub-core) with a 56-byte
// stack frame (76 bytes of spill stores, 244 of spill loads).
// kSaved: twelve warps, 232,380 bytes, no spills: 150 registers with db (kernel
// 4), 146 without (kernel 7).

#pragma once

#include "attention_regs_fwd.cuh"

namespace demo2 {
namespace {

// Where P comes from and where the backward rounds:
//   kSaved (packed_attention.py::_bwd_saved(_db)_kernel, kernels 4 and 7, and
//       the attention part of kernel 8): P is the forward's saved bf16 p; dS
//       uses that bf16 p and is rounded to bf16 before the dQ / dK products;
//   kRecompute (packed_attention.py::_bwd_kernel, kernel 6): p is recomputed
//       from Q and K in f32 (exp(s - max) / (sum + 1e-30)); dV takes bf16(p),
//       dS takes the f32 p and is rounded to bf16 before the dQ / dK products;
//   kRecomputeF32 (flash_attention.py::_bwd_kernel, kernel 10): f32
//       throughout.
enum class Probs { kSaved, kRecompute, kRecomputeF32 };

// kRegsBwdRing x [Q | K | V | dO], [kSaved: kRegsBwdRing x P], the statistics
// per ring slot (m / rinv / delta; kSaved: delta alone), three mbarriers per
// slot, the index of the last item loaded into it (wait_started,
// attention_regs_fwd.cuh) and [kSaved] the db accumulator of the block (dq |
// dk | dv, 64 floats each) with the counter of its turns.
constexpr int kRegsBwdRing = 2;
constexpr int kRegsPTile = kMaxSeq * kMaxSeq;  // a saved P: <= 144 rows of S16 <= 144 bf16
constexpr int kRegsBwdWarps = 12;  // three on each sub-core (the forward has four)
constexpr int kRegsBwdThreads = kRegsBwdWarps * 32;
__host__ __device__ constexpr int regs_bwd_stats(Probs mode) {
  return mode == Probs::kSaved ? 1 : 3;
}
__host__ __device__ constexpr int regs_bwd_smem_bytes(Probs mode) {
  return kRegsBwdRing * 4 * kRegsTile * static_cast<int>(sizeof(bf16)) +
         (mode == Probs::kSaved ? kRegsBwdRing * kRegsPTile * static_cast<int>(sizeof(bf16)) : 0) +
         kRegsBwdRing * regs_bwd_stats(mode) * kMaxSeq * static_cast<int>(sizeof(float)) +
         3 * kRegsBwdRing * 8 + kRegsBwdRing * 4 +
         (mode == Probs::kSaved ? 3 * kHeadDim * static_cast<int>(sizeof(float)) + 4 : 0);
}
static_assert(regs_bwd_smem_bytes(Probs::kRecompute) == 150968 &&
                  regs_bwd_smem_bytes(Probs::kSaved) <= 232448,
              "the ring of Q, K, V, dO [and P] must fit one SM");
static_assert((kRegsBwdRing * 4 * kRegsTile * sizeof(bf16)) % 16 == 0 &&
                  (kRegsPTile * sizeof(bf16)) % 16 == 0 &&
                  (kRegsBwdRing * kMaxSeq * sizeof(float)) % 8 == 0 && kRegsBwdRing % 2 == 0,
              "P is a 16-byte bulk copy, the statistics and the db accumulator are read as "
              "float2, the barriers are 8-byte words");

// The warp's 16 x 64 f32 tile (accumulator layout), times `mul`, rounded to
// bf16 once, to rows row0 .. row0 + 15 < S of dst (row stride `row`): a quad
// writes 16 consecutive bytes, two of its stores fill a 32-byte sector.
__device__ __forceinline__ void store_tile_direct(const float (&o)[kRegsDim8][4], float mul,
                                                  bf16* dst, int row, int row0, int S, int lane) {
  const int r = row0 + (lane >> 2);
  bf16* p = dst + static_cast<size_t>(r) * row + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < kRegsDim8; ++nt) {
    if (r < S)
      *reinterpret_cast<uint32_t*>(p + nt * 8) = pack_bf16x2(o[nt][0] * mul, o[nt][1] * mul);
    if (r + 8 < S)
      *reinterpret_cast<uint32_t*>(p + static_cast<size_t>(8) * row + nt * 8) =
          pack_bf16x2(o[nt][2] * mul, o[nt][3] * mul);
  }
}

// ---- Probs::kSaved: the saved P tile, and db -----------------------------------

// `bytes` (a multiple of 16) of contiguous device memory to shared memory by
// one bulk copy; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The two bf16 halves of a register as f32.
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// out (16 x 64, accumulator layout) += A B with A 16 x 16 bf16 values as one
// A-operand fragment `a` and B rows 16 j .. 16 j + 15 of the swizzled tile
// `b`, [k][d] bf16: one step of product_regs (attention_regs_fwd.cuh) for an
// operand that is bf16 already.
__device__ __forceinline__ void product_frag(float (&out)[kRegsDim8][4], const uint32_t (&a)[4],
                                             const bf16* b, int j, int lane) {
#pragma unroll
  for (int dp = 0; dp < kRegsDim8 / 2; ++dp) {
    uint32_t fb[4];
    ldmatrix_x4_trans(fb, swizzled(b, j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                   dp * 2 + (lane >> 4)));
    mma_bf16(out[2 * dp], a, fb[0], fb[1]);
    mma_bf16(out[2 * dp + 1], a, fb[2], fb[3]);
  }
}

// The warp's 16 x 64 f32 tile (accumulator layout), times `mul`, rounded to
// bf16 once, as pairs: r[nt][0] at row lane / 4, columns 8 nt + 2 (lane % 4) +
// {0, 1}, r[nt][1] eight rows down.  One conversion instruction a pair, whose
// result serves the store and the column sums both.
__device__ __forceinline__ void round_tile(const float (&o)[kRegsDim8][4], float mul,
                                           uint32_t (&r)[kRegsDim8][2]) {
#pragma unroll
  for (int nt = 0; nt < kRegsDim8; ++nt) {
    const __nv_bfloat162 top = __floats2bfloat162_rn(o[nt][0] * mul, o[nt][1] * mul);
    const __nv_bfloat162 bottom = __floats2bfloat162_rn(o[nt][2] * mul, o[nt][3] * mul);
    r[nt][0] = *reinterpret_cast<const uint32_t*>(&top);
    r[nt][1] = *reinterpret_cast<const uint32_t*>(&bottom);
  }
}

// store_tile_direct for a tile that round_tile has rounded.
__device__ __forceinline__ void store_rounded_tile(const uint32_t (&r)[kRegsDim8][2], bf16* dst,
                                                   int row, int row0, int S, int lane) {
  const int q = row0 + (lane >> 2);
  bf16* p = dst + static_cast<size_t>(q) * row + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < kRegsDim8; ++nt) {
    if (q < S) *reinterpret_cast<uint32_t*>(p + nt * 8) = r[nt][0];
    if (q + 8 < S)
      *reinterpret_cast<uint32_t*>(p + static_cast<size_t>(8) * row + nt * 8) = r[nt][1];
  }
}

// The column sums of a rounded 16 x 64 tile, rows >= S left out.  A
// transposing shuffle tree over the eight row groups: each step halves what a
// lane holds, so lane l ends with the sums of columns 2 l and 2 l + 1.  The
// order of the additions is fixed.
__device__ __forceinline__ float2 tile_column_sums(const uint32_t (&r)[kRegsDim8][2], int row0,
                                                   int S, int lane) {
  const bool top = row0 + (lane >> 2) < S;
  const bool bottom = row0 + (lane >> 2) + 8 < S;
  float s8[kRegsDim8][2];
#pragma unroll
  for (int nt = 0; nt < kRegsDim8; ++nt) {
    const uint32_t t = top ? r[nt][0] : 0u;
    const uint32_t u = bottom ? r[nt][1] : 0u;
    s8[nt][0] = bf16_lo(t) + bf16_lo(u);
    s8[nt][1] = bf16_hi(t) + bf16_hi(u);
  }
  float s4[4][2], s2[2][2];
  float2 s1;
  const bool b4 = (lane & 16) != 0, b3 = (lane & 8) != 0, b2 = (lane & 4) != 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      s4[i][e] = (b4 ? s8[i + 4][e] : s8[i][e]) +
                 __shfl_xor_sync(0xffffffffu, b4 ? s8[i][e] : s8[i + 4][e], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      s2[i][e] = (b3 ? s4[i + 2][e] : s4[i][e]) +
                 __shfl_xor_sync(0xffffffffu, b3 ? s4[i][e] : s4[i + 2][e], 8);
  s1.x = (b2 ? s2[1][0] : s2[0][0]) + __shfl_xor_sync(0xffffffffu, b2 ? s2[0][0] : s2[1][0], 4);
  s1.y = (b2 ? s2[1][1] : s2[0][1]) + __shfl_xor_sync(0xffffffffu, b2 ? s2[0][1] : s2[1][1], 4);
  return s1;
}

// One addition of a db chain link: lane l adds its two sums to acc[2 l],
// acc[2 l + 1] (`first`: the item's first task starts them; `last`: its last
// task writes the total to `out`, 64 floats of db_partial, instead).
__device__ __forceinline__ void db_add(float* acc, bool first, bool last, float2 v, float* out,
                                       int lane) {
  float2* a = reinterpret_cast<float2*>(acc) + lane;
  if (!first) {
    const float2 before = *a;
    v.x += before.x;
    v.y += before.y;
  }
  if (last) {
    reinterpret_cast<float2*>(out)[lane] = v;
  } else {
    *a = v;
  }
}

// The db sums are added in the order of the stream: a task waits here until
// the task before it has passed the turn on (all lanes call both).
__device__ __forceinline__ void db_wait_turn(const volatile int* turn, int u) {
  while (*turn != u) {
  }
  __threadfence_block();
}
__device__ __forceinline__ void db_pass_turn(volatile int* turn, int u, int lane) {
  __threadfence_block();
  __syncwarp();
  if (lane == 0) *turn = u + 1;
}

// ---- the kernel ------------------------------------------------------------------

// Persistent, and a stream of tasks inside the block: an item is 2 x pairs
// tasks, its query-owner tiles and then its key-owner tiles; task u is task
// u % (2 pairs) of the block's item u / (2 pairs); warp w takes tasks w,
// w + 12, ...  A key-owner task waits for the item's `pairs` query-owner
// tasks, all earlier in the stream, so no wait can form a cycle.
// `probs` (B, H, S, S16) bf16 and `db_partial` (B, 3C) f32: kSaved [kDb] only.
template <Probs kMode, bool kDb = false>
__global__ void __launch_bounds__(kRegsBwdThreads, 1)
attention_regs_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const bf16* __restrict__ probs, bf16* __restrict__ dq,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, HeadLayout outl,
                          float* __restrict__ db_partial, int S, int heads, int items,
                          float scale) {
  constexpr bool kSaved = kMode == Probs::kSaved;
  constexpr bool kSplit = kMode == Probs::kRecomputeF32;
  constexpr int kStats = regs_bwd_stats(kMode);
  static_assert(kSaved || !kDb, "db is kernel 4's, from saved probs");
  extern __shared__ __align__(1024) unsigned char regs_bwd_smem[];
  bf16* smem = reinterpret_cast<bf16*>(regs_bwd_smem);
  bf16* p_tiles = smem + kRegsBwdRing * 4 * kRegsTile;  // kSaved
  float* stats = reinterpret_cast<float*>(p_tiles + (kSaved ? kRegsBwdRing * kRegsPTile : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kRegsBwdRing * kStats * kMaxSeq);
  uint64_t* empty = full + kRegsBwdRing;
  uint64_t* ready = empty + kRegsBwdRing;  // the item's statistics are complete
  volatile int* started = reinterpret_cast<volatile int*>(ready + kRegsBwdRing);
  // kDb: the block's running sums, dq | dk | dv, and the stream index of the
  // task whose sums are added next.
  float* db_acc = const_cast<float*>(reinterpret_cast<volatile float*>(started + kRegsBwdRing));
  volatile int* db_turn = reinterpret_cast<volatile int*>(db_acc + 3 * kHeadDim);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int s_pad = (S + 15) & ~15;
  const int pairs = s_pad / 16;
  const int mine = block_items(items);
  const float c = scale * kLog2e;

  if (threadIdx.x == 0) {
    for (int b = 0; b < kRegsBwdRing; ++b) {
      mbar_init(full + b, 1);
      mbar_init(empty + b, pairs);  // one arrival per key-owner task
      mbar_init(ready + b, pairs);  // one arrival per query-owner task
      started[b] = -1;
    }
    if (kDb) *db_turn = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kSaved) {  // rows >= S of both P tiles: no copy ever writes them
    const int words = (s_pad - S) * s_pad / 2;
    for (int b = 0; b < kRegsBwdRing; ++b) {
      uint32_t* rows = reinterpret_cast<uint32_t*>(p_tiles + b * kRegsPTile + S * s_pad);
      for (int i = threadIdx.x; i < words; i += kRegsBwdThreads) rows[i] = 0u;
    }
  }
  __syncthreads();

  auto load = [&](int i) {  // one lane: the block's i-th item into slot i % kRegsBwdRing
    const int item = blockIdx.x + i * gridDim.x;
    const int slot = i % kRegsBwdRing;
    bf16* dst = smem + slot * 4 * kRegsTile;
    const uint32_t p_bytes = kSaved ? static_cast<uint32_t>(S * s_pad * sizeof(bf16)) : 0u;
    mbar_arrive_expect(full + slot, static_cast<uint32_t>(4 * s_pad * kRegsRowBytes) + p_bytes);
    tma_load_head(dst, &q_map, item % heads, item / heads, full + slot);
    tma_load_head(dst + kRegsTile, &k_map, item % heads, item / heads, full + slot);
    tma_load_head(dst + 2 * kRegsTile, &v_map, item % heads, item / heads, full + slot);
    tma_load_head(dst + 3 * kRegsTile, &do_map, item % heads, item / heads, full + slot);
    if (kSaved) {
      bulk_load(p_tiles + slot * kRegsPTile, probs + static_cast<size_t>(item) * S * s_pad,
                p_bytes, full + slot);
    }
    started[slot] = i;
  };
  if (warp == 0 && lane == 0 && mine > 0) load(0);

  for (int u = warp; u < mine * 2 * pairs; u += kRegsBwdWarps) {
    const int i = u / (2 * pairs);
    const int task = u - i * 2 * pairs;
    const bool key_owner = task >= pairs;
    const int tile = key_owner ? task - pairs : task;
    const int row0 = tile * 16;
    const int b = i % kRegsBwdRing;
    const uint32_t parity = (i / kRegsBwdRing) & 1;
    const int item = blockIdx.x + i * gridDim.x;
    const bf16* q_s = smem + b * 4 * kRegsTile;
    const bf16* k_s = q_s + kRegsTile;
    const bf16* v_s = k_s + kRegsTile;
    const bf16* do_s = v_s + kRegsTile;
    const bf16* p_s = p_tiles + b * kRegsPTile;  // kSaved: [query][key], rows of s_pad
    float* m_s = stats + b * kStats * kMaxSeq;   // kRecompute*: m | rinv | delta
    float* rinv_s = m_s + kMaxSeq;
    float* delta_s = kSaved ? m_s : rinv_s + kMaxSeq;
    const size_t dst = outl.at(item / heads, item % heads);
    // kDb: the head's 64 columns of the sample's dq section of db_partial.
    const int C = heads * kHeadDim;
    float* db_out =
        db_partial + static_cast<size_t>(item / heads) * 3 * C + (item % heads) * kHeadDim;
    wait_started(started + b, i);
    mbar_wait(full + b, parity);

    if (!key_owner) {  // query rows row0 .. row0 + 15
      float ds[kRegsCols8][4];
      float delta0 = 0.f, delta1 = 0.f;
      if constexpr (kSaved) {
        product_rows(ds, do_s, row0, v_s, pairs, lane);
        // P rows as bf16 pairs, where dP has its f32 pairs.
        const bf16* p_rows = p_s + (row0 + (lane & 15)) * s_pad + (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < kRegsTiles; ++j) {
          if (j < pairs) {
            uint32_t pf[4];
            ldmatrix_x4(pf, p_rows + j * 16);
            delta0 += ds[2 * j][0] * bf16_lo(pf[0]) + ds[2 * j][1] * bf16_hi(pf[0]) +
                      ds[2 * j + 1][0] * bf16_lo(pf[2]) + ds[2 * j + 1][1] * bf16_hi(pf[2]);
            delta1 += ds[2 * j][2] * bf16_lo(pf[1]) + ds[2 * j][3] * bf16_hi(pf[1]) +
                      ds[2 * j + 1][2] * bf16_lo(pf[3]) + ds[2 * j + 1][3] * bf16_hi(pf[3]);
          }
        }
        delta0 = quad_sum(delta0);
        delta1 = quad_sum(delta1);
        if (tq == 0) {
          delta_s[row0 + g] = delta0;
          delta_s[row0 + g + 8] = delta1;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ready + b);
#pragma unroll
        for (int j = 0; j < kRegsTiles; ++j) {
          if (j < pairs) {
            uint32_t pf[4];  // read again: 4 registers live in place of 36
            ldmatrix_x4(pf, p_rows + j * 16);
            ds[2 * j][0] = bf16_lo(pf[0]) * (ds[2 * j][0] - delta0);
            ds[2 * j][1] = bf16_hi(pf[0]) * (ds[2 * j][1] - delta0);
            ds[2 * j][2] = bf16_lo(pf[1]) * (ds[2 * j][2] - delta1);
            ds[2 * j][3] = bf16_hi(pf[1]) * (ds[2 * j][3] - delta1);
            ds[2 * j + 1][0] = bf16_lo(pf[2]) * (ds[2 * j + 1][0] - delta0);
            ds[2 * j + 1][1] = bf16_hi(pf[2]) * (ds[2 * j + 1][1] - delta0);
            ds[2 * j + 1][2] = bf16_lo(pf[3]) * (ds[2 * j + 1][2] - delta1);
            ds[2 * j + 1][3] = bf16_hi(pf[3]) * (ds[2 * j + 1][3] - delta1);
          }
        }
      } else {
        float p[kRegsCols8][4];
        product_rows(p, q_s, row0, k_s, pairs, lane);
        float m0, m1, rinv0, rinv1;
        softmax_rows<true>(p, pairs, S, c, lane, m0, m1, rinv0, rinv1);
        product_rows(ds, do_s, row0, v_s, pairs, lane);
#pragma unroll
        for (int nt = 0; nt < kRegsCols8; ++nt) {
          if (nt < 2 * pairs) {
            delta0 += ds[nt][0] * p[nt][0] + ds[nt][1] * p[nt][1];
            delta1 += ds[nt][2] * p[nt][2] + ds[nt][3] * p[nt][3];
          }
        }
        delta0 = quad_sum(delta0);
        delta1 = quad_sum(delta1);
        if (tq == 0) {
          m_s[row0 + g] = m0;
          m_s[row0 + g + 8] = m1;
          rinv_s[row0 + g] = row0 + g < S ? rinv0 : 0.f;
          rinv_s[row0 + g + 8] = row0 + g + 8 < S ? rinv1 : 0.f;
          delta_s[row0 + g] = delta0;
          delta_s[row0 + g + 8] = delta1;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ready + b);
#pragma unroll
        for (int nt = 0; nt < kRegsCols8; ++nt) {
          if (nt < 2 * pairs) {
            ds[nt][0] = p[nt][0] * (ds[nt][0] - delta0);
            ds[nt][1] = p[nt][1] * (ds[nt][1] - delta0);
            ds[nt][2] = p[nt][2] * (ds[nt][2] - delta1);
            ds[nt][3] = p[nt][3] * (ds[nt][3] - delta1);
          }
        }
      }
      float acc[kRegsDim8][4];
#pragma unroll
      for (int nt = 0; nt < kRegsDim8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      product_regs<kSplit>(acc, ds, k_s, pairs, lane);
      float2 dq_sums = make_float2(0.f, 0.f);
      if constexpr (kSaved) {
        uint32_t rounded[kRegsDim8][2];
        round_tile(acc, scale, rounded);
        store_rounded_tile(rounded, dq + dst, outl.row, row0, S, lane);
        if constexpr (kDb) dq_sums = tile_column_sums(rounded, row0, S, lane);
      } else {
        store_tile_direct(acc, scale, dq + dst, outl.row, row0, S, lane);
      }
      // The warp that took an item's first task asks for the next item, into
      // the other slot, once the item before this one is consumed.
      const int ahead = i + kRegsBwdRing - 1;
      if (task == 0 && ahead < mine && lane == 0) {
        if (ahead >= kRegsBwdRing) {
          wait_started(started + ahead % kRegsBwdRing, ahead - kRegsBwdRing);
          mbar_wait(empty + ahead % kRegsBwdRing, (ahead / kRegsBwdRing - 1) & 1);
        }
        load(ahead);
      }
      __syncwarp();
      if constexpr (kDb) {
        db_wait_turn(db_turn, u);
        db_add(db_acc, tile == 0, tile == pairs - 1, dq_sums, db_out, lane);
        db_pass_turn(db_turn, u, lane);
      }
    } else {  // keys row0 .. row0 + 15: rows are keys, columns queries
      float acc[kRegsDim8][4];
#pragma unroll
      for (int nt = 0; nt < kRegsDim8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      float dst_t[kRegsCols8][4];
      float2 dv_sums = make_float2(0.f, 0.f);
      if constexpr (kSaved) {
        // P^T by ldmatrix.trans: the A operand of dV as it stands.
        const bf16* p_cols =
            p_s + (((lane >> 4) << 3) + (lane & 7)) * s_pad + row0 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j = 0; j < kRegsTiles; ++j) {
          if (j < pairs) {
            uint32_t pt[4];
            ldmatrix_x4_trans(pt, p_cols + j * 16 * s_pad);
            product_frag(acc, pt, do_s, j, lane);
          }
        }
        uint32_t rounded[kRegsDim8][2];
        round_tile(acc, 1.f, rounded);
        store_rounded_tile(rounded, dv + dst, outl.row, row0, S, lane);
        if constexpr (kDb) dv_sums = tile_column_sums(rounded, row0, S, lane);
        product_rows(dst_t, v_s, row0, do_s, pairs, lane);
        mbar_wait(ready + b, parity);  // delta alone comes from the query-owner tasks
#pragma unroll
        for (int j = 0; j < kRegsTiles; ++j) {
          if (j < pairs) {
            const float2 d0 = *reinterpret_cast<const float2*>(delta_s + j * 16 + 2 * tq);
            const float2 d1 = *reinterpret_cast<const float2*>(delta_s + j * 16 + 8 + 2 * tq);
            uint32_t pt[4];  // read again: 4 registers live in place of 36
            ldmatrix_x4_trans(pt, p_cols + j * 16 * s_pad);
            dst_t[2 * j][0] = bf16_lo(pt[0]) * (dst_t[2 * j][0] - d0.x);
            dst_t[2 * j][1] = bf16_hi(pt[0]) * (dst_t[2 * j][1] - d0.y);
            dst_t[2 * j][2] = bf16_lo(pt[1]) * (dst_t[2 * j][2] - d0.x);
            dst_t[2 * j][3] = bf16_hi(pt[1]) * (dst_t[2 * j][3] - d0.y);
            dst_t[2 * j + 1][0] = bf16_lo(pt[2]) * (dst_t[2 * j + 1][0] - d1.x);
            dst_t[2 * j + 1][1] = bf16_hi(pt[2]) * (dst_t[2 * j + 1][1] - d1.y);
            dst_t[2 * j + 1][2] = bf16_lo(pt[3]) * (dst_t[2 * j + 1][2] - d1.x);
            dst_t[2 * j + 1][3] = bf16_hi(pt[3]) * (dst_t[2 * j + 1][3] - d1.y);
          }
        }
      } else {
        mbar_wait(ready + b, parity);
        float pt[kRegsCols8][4];
        product_rows(pt, k_s, row0, q_s, pairs, lane);
#pragma unroll
        for (int nt = 0; nt < kRegsCols8; ++nt) {
          if (nt < 2 * pairs) {
            const float2 m = *reinterpret_cast<const float2*>(m_s + nt * 8 + 2 * tq);
            const float2 r = *reinterpret_cast<const float2*>(rinv_s + nt * 8 + 2 * tq);
            pt[nt][0] = exp2_approx(fmaf(pt[nt][0], c, -m.x)) * r.x;
            pt[nt][1] = exp2_approx(fmaf(pt[nt][1], c, -m.y)) * r.y;
            pt[nt][2] = exp2_approx(fmaf(pt[nt][2], c, -m.x)) * r.x;
            pt[nt][3] = exp2_approx(fmaf(pt[nt][3], c, -m.y)) * r.y;
          }
        }
        product_regs<kSplit>(acc, pt, do_s, pairs, lane);
        store_tile_direct(acc, 1.f, dv + dst, outl.row, row0, S, lane);

        product_rows(dst_t, v_s, row0, do_s, pairs, lane);
#pragma unroll
        for (int nt = 0; nt < kRegsCols8; ++nt) {
          if (nt < 2 * pairs) {
            const float2 d = *reinterpret_cast<const float2*>(delta_s + nt * 8 + 2 * tq);
            dst_t[nt][0] = pt[nt][0] * (dst_t[nt][0] - d.x);
            dst_t[nt][1] = pt[nt][1] * (dst_t[nt][1] - d.y);
            dst_t[nt][2] = pt[nt][2] * (dst_t[nt][2] - d.x);
            dst_t[nt][3] = pt[nt][3] * (dst_t[nt][3] - d.y);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kRegsDim8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      product_regs<kSplit>(acc, dst_t, q_s, pairs, lane);
      float2 dk_sums = make_float2(0.f, 0.f);
      if constexpr (kSaved) {
        uint32_t rounded[kRegsDim8][2];
        round_tile(acc, scale, rounded);
        store_rounded_tile(rounded, dk + dst, outl.row, row0, S, lane);
        if constexpr (kDb) dk_sums = tile_column_sums(rounded, row0, S, lane);
      } else {
        store_tile_direct(acc, scale, dk + dst, outl.row, row0, S, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + b);
      if constexpr (kDb) {
        db_wait_turn(db_turn, u);
        db_add(db_acc + kHeadDim, tile == 0, tile == pairs - 1, dk_sums, db_out + C, lane);
        db_add(db_acc + 2 * kHeadDim, tile == 0, tile == pairs - 1, dv_sums, db_out + 2 * C, lane);
        db_pass_turn(db_turn, u, lane);
      }
    }
  }
}

// `probs` and `db_partial`: Probs::kSaved [kDb] only.
template <Probs kMode, bool kDb = false>
cudaError_t launch_attention_regs_bwd(const bf16* q, const bf16* k, const bf16* v, HeadLayout in,
                                      const bf16* dout, HeadLayout dol, bf16* dq, bf16* dk,
                                      bf16* dv, HeadLayout outl, int batch, int seq, int heads,
                                      float scale, cudaStream_t st, const bf16* probs = nullptr,
                                      float* db_partial = nullptr) {
  auto kernel = attention_regs_bwd_kernel<kMode, kDb>;
  constexpr int smem = regs_bwd_smem_bytes(kMode);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(batch * heads, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const bf16* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    err = head_tensor_map(&maps[i], bases[i], i < 3 ? in : dol, batch, seq, heads);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kRegsBwdThreads, smem, st>>>(maps[0], maps[1], maps[2], maps[3], probs, dq, dk, dv,
                                          outl, db_partial, seq, heads, batch * heads, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2
