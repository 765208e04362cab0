// The block kernels' attention past the wide forms: heads of 64 over 257-512
// tokens (the CLIP flagship at MODEL.STRIDE_SIZE (12, 12) on TransReID's
// stride-12 crops: 311 tokens at 384x128, 442 at 256x256).  The wide forms
// (attention_wide_block.cuh) hold whole-head operand tiles of one item and,
// in the backward, an item's dK and dV for its 256 keys in registers; the
// wrappers send the longer sequences here (ops/packed_attention.py::
// block_form).
//
//   block_long_fwd_kernel<kSaveProbs>: launch 3 of kernels 1 and 3
//       (fused_attention_block.cu, the _long entries), the attention of
//       demo2_tpu/ops/fused_block.py::_fwd_kernel_core (kernel 1 :128,
//       pallas_call :218; kernel 3 :118, pallas_call :164) in its rounding
//       mode (Softmax::kNormBeforePV): s = (q k^T) * scale in f32, keys >= S
//       left out, p = expf(s - rowmax) / (rowsum + 1e-30) in f32, rounded to
//       bf16 once, o = bf16(p_bf16 v) with f32 accumulation.  Kernel 3's form
//       also stores that very bf16 p into probs (B, H, S, S16), columns >= S
//       zero.  Kernel 1 is the same code without the probs store, so its out
//       is kernel 3's bit for bit.
//   block_long_bwd_kernel<kDb>: kernels 4 (kDb) and 7, and so the first stage
//       of kernel 8 (attention_bwd.cu, the _long entries), replacing
//       demo2_tpu/ops/packed_attention.py::_bwd_saved_db_kernel (:264,
//       pallas_call :338) and ::_bwd_saved_kernel (:231, pallas_call :508) in
//       their rounding mode (Probs::kSaved): P the saved bf16 p, not
//       recomputed; dV = P^T dO, dP = dO V^T, dS = bf16(P (dP - rowsum(dP
//       P))), dQ = dS K * scale, dK = dS^T Q * scale, each rounded to bf16
//       once; with kDb the f32 column sums of the rounded dq, dk, dv, added in
//       a fixed order (no atomics) into two rows of db_partial (2B, 3C) a
//       sample, which attention_bwd.cu's db_reduce_kernel then adds in order.
//       Kernel 7 is the same code with the sums compiled out, so its dqkv
//       equals kernel 4's bit for bit.
// p is computed by the plain versions' operations (expf, the scale by an
// unfused multiply, the quotient by wide_quotient), as in the wide forms.
//
// What bounds them on an H100 at x (192, 442, 768), 12 heads of 64: kernels 1
// and 3 as a whole (LN, the two projections on gemm_sm90.cuh, this attention)
// count 515.6 GFLOP, 0.5214 ms at 989 TFLOP/s: operations (kernel 3's bytes
// alone, x, out, qkv, attn and the 912.5 MB of probs, 1.70 GB: 0.506 ms);
// this launch alone counts 230.5 GFLOP (0.233 ms) against the 1.37 GB it
// must move in kernel 3 (0.41 ms).  Kernels 4 and 7 move qkv, probs, dO and
// dqkv (1.83 GB, 0.5448 ms at 3.35 TB/s) for 230.5 GFLOP: bytes.  Times:
// PERF.md §6.
//
// The design.  The forward is the second long form; the first held
// 16-row tasks on mma.sync, four warps a task, and ran at ~12 µs a task.  Its
// queries come in 64-row tiles and its products are wgmma of a warpgroup
// (wgmma_shapes.cuh): K and V leave shared memory once per 64 query rows, and
// a task's softmax exchange runs once per 64 rows.  The backward is the
// first long form: a 64-row, wgmma design over a cluster of four blocks
// passed every check but read slower in turns (PERF.md §6).
//   * Forward (two warpgroups, 256 threads, one block an SM, persistent over
//     items): task u is 64-row tile u % tiles of the block's item u / tiles.
//     K and V of an item come by TMA into a ring of operand slots (S64 rows
//     in two boxes; the next item's K lands while this item runs),
//     Q's 64 rows into a ring of two Q slots, each released by the warps
//     that read it; the warp whose release completes a slot asks for the
//     slot's next operand (attention_wide.cuh::WideRing).  Warpgroup w holds
//     half of the task's keys, kC = S64 / 64 chunks of 32 (a template
//     parameter, 5-8, so that every loop over them is straight-line code):
//     its QK^T is one wgmma m64n32k16 a chunk and 16 keys of depth, A (Q)
//     from registers, and the f32 scores stay in registers (16 kC a thread).
//     keys >= S become -inf, the two warpgroups trade their row maxima and
//     then their row sums through shared memory (the sum is
//     warpgroup 0's plus warpgroup 1's in both), expf runs once a score, the
//     quotient by the correctly rounded reciprocal and one fma
//     (wide_quotient), and p is rounded to bf16 once into the A fragments of
//     PV: a wgmma m64n64k16 a 16 keys, B (V) MN-major from its slot.  O =
//     warpgroup 0's partial plus warpgroup 1's, each warpgroup ending 32 of
//     the 64 columns.  Kernel 3 writes its bf16 p a warp's 16 x 64 block at
//     a time into a staging tile and copies it to probs with 16-byte stores
//     (rows >= S and columns >= S16 left out).
//   * Backward (a cluster of two blocks an item, twelve warps each): an
//     item's dK and dV accumulators over 512 keys (256 KB of f32) would fill
//     the whole register file of an SM, so the keys are split, not walked:
//     block r of the cluster owns key tiles [16 r0, ...) of every item, the
//     first ceil(tiles / 2) for r = 0, the rest for r = 1, and runs the wide
//     backward's two roles over them.  V and K of its keys come by TMA into
//     the operand ring; each 16-row tile n of the item brings, into strip
//     slot n mod nstrips, the block's columns of P (16 rows x 64-column boxes),
//     and Q's and dO's sixteen rows.  Four query warps take the tiles in turn:
//     dP = dO_t V^T over the block's keys (computed once: each block computes
//     its own columns), the partial delta = rowsum(dP P) over them, which the
//     two blocks trade through distributed shared memory (delta = d0 + d1,
//     the same bits in both: two terms add alike in either order); dS = P (dP
//     - delta) rounded to bf16 once into the slot, then dQ's partial over the
//     block's keys, and the blocks trade the halves of it: block r ends
//     columns 32 r .. 32 r + 31 of dQ, adding its own partial and the other's.
//     Eight key warps own 32 keys each of the block's keys and take P^T and
//     dS^T of them from the slot by ldmatrix.trans: dV += P^T dO_t, dK +=
//     dS^T Q_t.  So P leaves device memory once (each block reads its
//     columns), dP is computed once, and dK is taken from the very dS that dQ
//     is.  Each exchange is a mailbox a strip slot in the receiving block,
//     filled by the other block's warp of the same tile, which arrives on the
//     mailbox's `full` mbarrier (release, cluster scope); the receiver arrives
//     on the sender's `empty` mbarrier once it has read the tile's delta and
//     dQ, and the sender of tile n + nstrips waits for it.  Every wait is for
//     an event of the same or an earlier tile of the two blocks' common
//     stream, so none can form a cycle.  db: the dq column sums (the other
//     block's columns read as 0) in query-warp order, the dk, dv sums of the
//     block's keys in key-warp order, each block into its own row of
//     db_partial.  A block never leaves while the other may still address its
//     shared memory (a cluster barrier at the end).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/compare_trees.py in turns
// against the first long forward, PERF.md §6): at x (192, 442, 768) kernels
// 1 / 3 1.6159, 1.6127 / 1.7361, 1.7308 ms against 2.0322, 2.0354 / 2.2212,
// 2.2284, their launch 3 alone (the profiler) 0.833 / 0.947 against 1.250 /
// 1.422 (scaled_dot_product_attention's forward there: 0.437); at (64, 311,
// 768) 0.3857, 0.3838 / 0.4114, 0.4094 against 0.4608, 0.4703 / 0.4934,
// 0.5044.  With the chunk loops bounded at run time (no kC) ptxas serialized
// every wgmma (its C7520 note) and the same forward read 2.64 / 3.35 ms.
// Resources (nvcc -Xptxas -v, sm_90a; phase 1 prints them): the forward
// 187 / 213 / 242 / 254 registers at kC = 5-8 (kernel 1; kernel 3 168 /
// 224 / 255 / 255), no spills; the backward 168, 32 / 64 bytes of spill
// stores (kernels 7 / 4).

#pragma once

#include "attention_wide_block.cuh"
#include "wgmma_shapes.cuh"

namespace demo2 {
namespace {

constexpr int kLongMaxSeq = 512;
constexpr int kLongTileBytes = 64 * 64 * static_cast<int>(sizeof(bf16));  // 64 rows of a head
// The forward: two warpgroups, each half of a task's 32-key chunks (at most
// 8), two Q slots, kernel 3's staging tile a warp (16 x 64 bf16), and the
// exchange: the row maxima and sums of both warpgroups (64 each) and the
// half of O that the other warpgroup ends (16 x 128 f32 each).
constexpr int kLongFwdThreads = 256;
constexpr int kLongChunk = 32;
constexpr int kLongQSlots = 2;
constexpr int kLongStageBytes = 8 * 16 * 64 * static_cast<int>(sizeof(bf16));
constexpr int kLongFwdXBytes = (2 * 2 * 64 + 2 * 16 * 128) * 4;
constexpr int kLongMaxPairs = kLongMaxSeq / 16;  // 16-row tiles of the longest sequence: 32
// The backward: a block's key tiles (at most half of 32), its query warps
// (the wide backward's four) and key warps (eight, 32 keys each).
constexpr int kLongHalfPairs = kLongMaxPairs / 2;
constexpr int kLongQueryWarps = kBlockWideQueryWarps;
constexpr int kLongKeyWarps = kBlockWideKeyWarps;
constexpr int kLongBwdWarps = kLongQueryWarps + kLongKeyWarps;
static_assert(kLongKeyWarps * 32 == kLongHalfPairs * 16, "the key warps hold a block's keys");
// A strip slot: the block's columns of a 16-row P tile (four 16 x 64 boxes),
// Q's and dO's 16 rows (one 16 x 64 tile each), then the dS the query side
// computes, laid out as P.
constexpr int kLongRowTileElems = 16 * 64;
constexpr int kLongStripQ = kProbsTileElems;
constexpr int kLongStripDo = kLongStripQ + kLongRowTileElems;
constexpr int kLongStripDs = kLongStripDo + kLongRowTileElems;
constexpr int kLongStripElems = kLongStripDs + kProbsTileElems;
constexpr int kLongStripBytes = kLongStripElems * static_cast<int>(sizeof(bf16));
constexpr int kLongMaxStrips = 8;
// A mailbox a strip slot: the other block's partial delta (16 rows, padded)
// and its half of dQ's partial (16 x 32 f32 in the accumulator layout,
// [column tile][element][lane]).
constexpr int kLongMailDelta = 32;
constexpr int kLongMailFloats = kLongMailDelta + 4 * 4 * 32;
// After the operand ring's words: five mbarriers a strip slot (dS full, dQ
// done, delta full, dQ full, mailbox empty), the db accumulator (dq | dk |
// dv, 64 floats each), the two turns of its sums, then a mailbox a strip
// slot (sized at launch).
constexpr int kLongBwdWords = 5 * kLongMaxStrips * 8 + 3 * 64 * 4 + 16;
constexpr int kLongBwdFixedBytes = kBlockWideStripBook + kWideSlotWords + kLongBwdWords;
constexpr int kLongStripCost = kLongStripBytes + kLongMailFloats * 4;
static_assert(kLongStripBytes % 1024 == 0 && (kLongStripQ * 2) % 1024 == 0 &&
                  (kLongStripDo * 2) % 1024 == 0 && (kLongStripDs * 2) % 1024 == 0,
              "every TMA destination and swizzled tile of a strip slot starts on 1,024 bytes");
static_assert(kWideSmemLimit - kLongBwdFixedBytes - 4 * kLongHalfPairs * 16 * 64 * 2 >=
                  kLongQueryWarps * kLongStripCost,
              "two items' V and K of a block and a strip slot a query warp fit at the longest S");
static_assert(kWideSmemLimit - kLongQSlots * kLongTileBytes - kLongStageBytes -
                      2 * kWideSlotWords - kLongFwdXBytes >=
                  2 * kLongMaxSeq * 64 * 2,
              "the forward's ring holds one item's K and V at the longest S");

// ---- cluster-scope primitives (sm_90) -------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// The address of `p` (this block's shared memory) in block `rank`'s.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void cluster_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
// An arrival on another block's mbarrier, ordering this thread's earlier
// accesses before it at cluster scope.
__device__ __forceinline__ void cluster_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// mbar_wait whose completion also orders the other block's accesses before
// this thread's later ones.
__device__ __forceinline__ void cluster_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Every thread of both blocks of the cluster.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// ---- operand copies ---------------------------------------------------------------

// One lane: `which` (0 q, 1 k, 2 v) of head h of sample b, rows row0 .. (the
// map's box; rows >= S zero) into the swizzled tile at dst, counted on `bar`
// (the caller expects the bytes).
__device__ __forceinline__ void long_copy(bf16* dst, const CUtensorMap* map, int h, int which,
                                          int row0, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(which), "r"(row0), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// Element (r, c) of a warp's staging tile (16 rows of 64 bf16 under the
// 128-byte swizzle, as attention_regs_fwd.cuh::swizzled).
__device__ __forceinline__ bf16* staged(bf16* tile, int r, int c) {
  return swizzled(tile, r, c >> 3) + (c & 7);
}

// A WideRing whose words lie apart from its tiles (so that the tiles of the
// ring after it still start on 1,024 bytes).
__device__ __forceinline__ void place_ring(WideRing& ring, unsigned char* tiles,
                                           unsigned char* words) {
  ring.tiles = reinterpret_cast<bf16*>(tiles);
  ring.full = reinterpret_cast<uint64_t*>(words);
  ring.empty = ring.full + kWideMaxSlots;
  ring.started = reinterpret_cast<volatile int*>(ring.empty + kWideMaxSlots);
  ring.released = const_cast<int*>(ring.started + kWideMaxSlots);
}

// This thread's warpgroup, as a value the compiler knows to be the same in
// every lane (a broadcast from lane 0), so that what depends on it never puts
// a wgmma on a divergent path, which ptxas would serialize.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
}

// The A fragments of rows 16 w .. 16 w + 15 of a 64 x 64 swizzled tile (Q's
// rows) over its four 16-column slices: warp w's part of a wgmma's A.
__device__ __forceinline__ void long_rows_a(uint32_t (&a)[4][4], const bf16* tile, int warp,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(a[kk], swizzled(tile, 16 * warp + (lane & 15), 2 * kk + (lane >> 4)));
}

// ---- the forward --------------------------------------------------------------------

// Persistent; task u is 64-row tile u % tiles of the block's item u / tiles,
// both warpgroups on every task, warpgroup w on the kC 32-key chunks from c0 =
// w kC (keys [32 c0, 32 (c0 + kC)): S64 = 64 kC keys in all, those >= S left
// out).  Operand 2 i + {0, 1} of the ring is K, V (S64 rows) of the block's
// item i; Q slot u % 2 holds task u's rows.  `probs` (B, H, S, S16):
// kSaveProbs only.
template <bool kSaveProbs, int kC>
__global__ void __launch_bounds__(kLongFwdThreads, 1)
block_long_fwd_kernel(const __grid_constant__ CUtensorMap kv_map,
                      const __grid_constant__ CUtensorMap q_map, bf16* __restrict__ out,
                      bf16* __restrict__ probs, int S, int C, int heads, int items, int slots,
                      float scale) {
  extern __shared__ __align__(1024) unsigned char block_long_fwd_smem[];
  const int wg = warpgroup_index(), warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int tid = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int s_pad = (S + 15) & ~15;
  constexpr int kS64 = 2 * kC * kLongChunk;
  const int c0 = wg * kC;
  const int tiles = (S + 63) / 64;
  const int mine = block_items(items);
  constexpr int kv_bytes = kS64 * 64 * static_cast<int>(sizeof(bf16));
  constexpr int kStage = kSaveProbs ? kLongStageBytes : 0;
  unsigned char* q_tiles = block_long_fwd_smem + slots * kv_bytes;
  unsigned char* words = q_tiles + kLongQSlots * kLongTileBytes + kStage;
  bf16* stage = reinterpret_cast<bf16*>(q_tiles + kLongQSlots * kLongTileBytes) +
                (4 * wg + warp) * 16 * 64;
  float* xm = reinterpret_cast<float*>(words + 2 * kWideSlotWords);  // [warpgroup][row]
  float* xs = xm + 2 * 64;
  float* xo = xs + 2 * 64;  // [the warpgroup that ends them][element][thread]
  WideRing ring{nullptr, nullptr, nullptr, nullptr, nullptr, slots, kS64 * 64, 8, 2 * mine};
  WideRing qring{nullptr, nullptr, nullptr, nullptr, nullptr, kLongQSlots, 64 * 64, 8,
                 mine * tiles};
  place_ring(ring, block_long_fwd_smem, words);
  place_ring(qring, q_tiles, words + kWideSlotWords);
  constexpr int box_rows = kS64 / 2;
  auto load = [&](int n, bf16* dst, uint64_t* bar) {
    const int item = blockIdx.x + (n >> 1) * gridDim.x;
    const int which = 1 + (n & 1);
    mbar_arrive_expect(bar, static_cast<uint32_t>(kv_bytes));
    long_copy(dst, &kv_map, item % heads, which, 0, item / heads, bar);
    long_copy(dst + box_rows * 64, &kv_map, item % heads, which, box_rows, item / heads, bar);
  };
  auto load_q = [&](int u, bf16* dst, uint64_t* bar) {
    const int i = u / tiles;
    const int item = blockIdx.x + i * gridDim.x;
    mbar_arrive_expect(bar, static_cast<uint32_t>(kLongTileBytes));
    long_copy(dst, &q_map, item % heads, 0, (u - i * tiles) * 64, item / heads, bar);
  };
  if (threadIdx.x == 0) {
    ring.reset();
    qring.reset();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int n = 0; n < slots && n < ring.ops; ++n) {
      load(n, ring.tiles + n * ring.slot_elems, ring.full + n);
      ring.started[n] = n;
    }
    for (int n = 0; n < kLongQSlots && n < qring.ops; ++n) {
      load_q(n, qring.tiles + n * qring.slot_elems, qring.full + n);
      qring.started[n] = n;
    }
  }

  for (int u = 0; u < mine * tiles; ++u) {
    const int i = u / tiles;
    const int r0 = (u - i * tiles) * 64;
    const bool last = r0 + 64 >= S;  // the item's last task
    const int item = blockIdx.x + i * gridDim.x;
    const int b = item / heads, h = item % heads;
    uint32_t qa[4][4];
    long_rows_a(qa, qring.acquire(u), warp, lane);
    qring.release(u, lane, load_q);
    // The one QK^T pass: this warpgroup's 64 x 32 kC scores, held.
    const bf16* k_s = ring.acquire(2 * i);
    float s[kC][16];
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const uint64_t desc = wgmma_desc(k_s + (c0 + c) * kLongChunk * 64);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) LongMma<32>::rs<0>(s[c], qa[kk], desc + 2 * kk, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kC; ++c) fence_regs(s[c]);
    if (last) ring.release(2 * i, lane, load);

    // s * scale (-inf at keys >= S: every element takes the same code), and
    // m = its maximum over both warpgroups.
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& v = s[c][4 * j + e];
          v = (c0 + c) * kLongChunk + 8 * j + 2 * t + (e & 1) < S ? __fmul_rn(v, scale)
                                                                   : -INFINITY;
        }
        m0 = fmaxf(m0, fmaxf(s[c][4 * j], s[c][4 * j + 1]));
        m1 = fmaxf(m1, fmaxf(s[c][4 * j + 2], s[c][4 * j + 3]));
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    const int row = 16 * warp + g;
    if (t == 0) {
      xm[64 * wg + row] = m0;
      xm[64 * wg + row + 8] = m1;
    }
    __syncthreads();
    m0 = fmaxf(xm[row], xm[64 + row]);
    m1 = fmaxf(xm[row + 8], xm[64 + row + 8]);
    // e = expf(s * scale - m) in place, once a score; the row sum is
    // warpgroup 0's plus warpgroup 1's.
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float x = expf(s[c][e] - ((e & 2) ? m1 : m0));
        s[c][e] = x;
        if (e & 2) sum1 += x; else sum0 += x;
      }
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    if (t == 0) {
      xs[64 * wg + row] = sum0;
      xs[64 * wg + row + 8] = sum1;
    }
    __syncthreads();
    const float d0 = (xs[row] + xs[64 + row]) + 1e-30f;
    const float d1 = (xs[row + 8] + xs[64 + row + 8]) + 1e-30f;
    const float rd0 = 1.f / d0, rd1 = 1.f / d1;

    // p = e / (sum + 1e-30), rounded to bf16 once: the A fragments of PV,
    // pa[c][hh] for keys 32 (c0 + c) + 16 hh ..
    uint32_t pa[kC][2][4];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        s[c][e] = wide_quotient(s[c][e], (e & 2) ? d1 : d0, (e & 2) ? rd1 : rd0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        pa[c][hh][0] = pack_bf16x2(s[c][8 * hh], s[c][8 * hh + 1]);
        pa[c][hh][1] = pack_bf16x2(s[c][8 * hh + 2], s[c][8 * hh + 3]);
        pa[c][hh][2] = pack_bf16x2(s[c][8 * hh + 4], s[c][8 * hh + 5]);
        pa[c][hh][3] = pack_bf16x2(s[c][8 * hh + 6], s[c][8 * hh + 7]);
      }
    }
    if constexpr (kSaveProbs) {
      // The warp's 16 rows of p to probs, 64 keys at a time through its
      // staging tile: 16-byte stores, rows >= S and columns >= S16 left out.
      bf16* prow = probs + (static_cast<size_t>(item) * S + r0 + 16 * warp) * s_pad;
#pragma unroll
      for (int bb = 0; bb < (kC + 1) / 2; ++bb) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          if (2 * bb + cc < kC) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int col = 32 * cc + 16 * hh + 2 * t;
              const uint32_t(&w)[4] = pa[2 * bb + cc][hh];
              *reinterpret_cast<uint32_t*>(staged(stage, g, col)) = w[0];
              *reinterpret_cast<uint32_t*>(staged(stage, g + 8, col)) = w[1];
              *reinterpret_cast<uint32_t*>(staged(stage, g, col + 8)) = w[2];
              *reinterpret_cast<uint32_t*>(staged(stage, g + 8, col + 8)) = w[3];
            }
          }
        }
        __syncwarp();
        const int col0 = (c0 + 2 * bb) * kLongChunk;
        const int cols = 2 * bb + 1 < kC ? 64 : kLongChunk;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = (lane >> 3) + 4 * k;
          const int col = 8 * (lane & 7);
          if (col < cols && col0 + col < s_pad && r0 + 16 * warp + r < S)
            *reinterpret_cast<uint4*>(prow + static_cast<size_t>(r) * s_pad + col0 + col) =
                *reinterpret_cast<const uint4*>(staged(stage, r, col));
        }
        __syncwarp();
      }
    }

    // This warpgroup's PV over its keys, B (V) MN-major from its slot.
    const bf16* v_s = ring.acquire(2 * i + 1);
    float o[32];
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        LongMma<64>::rs<1>(o, pa[c][hh],
                           wgmma_desc_mn(v_s + ((c0 + c) * kLongChunk + 16 * hh) * 64),
                           c > 0 || hh > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (last) ring.release(2 * i + 1, lane, load);
    // O = warpgroup 0's + warpgroup 1's; warpgroup w ends columns 32 w ..
    // 32 w + 31 (groups 4 w .. 4 w + 3), the other's half through xo.
    float* to = xo + (1 - wg) * 16 * 128;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) to[(4 * q + e) * 128 + tid] = o[4 * (4 * (1 - wg) + q) + e];
    __syncthreads();
    const float* from = xo + wg * 16 * 128;
    bf16* dst = out + (static_cast<size_t>(b) * S + r0 + row) * C + h * 64 + 32 * wg + 2 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mine_o = o[4 * (4 * wg + q) + e], other = from[(4 * q + e) * 128 + tid];
        v[e] = wg == 0 ? mine_o + other : other + mine_o;
      }
      if (r0 + row < S) *reinterpret_cast<uint32_t*>(dst + 8 * q) = pack_bf16x2(v[0], v[1]);
      if (r0 + row + 8 < S)
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(8) * C + 8 * q) =
            pack_bf16x2(v[2], v[3]);
    }
  }
}

// ---- the backward -------------------------------------------------------------------

// Persistent over clusters of two blocks; cluster c takes items c, c +
// clusters, ...  Block `rank` owns the key tiles [kj0, kj0 + kcnt).  Warps
// 0-3, the query side, take the item's 16-row tiles n = i pairs + tile in
// turn (warp w the tiles n = w mod 4), tile n in strip slot n mod nstrips;
// warps 4-11, the key side, own 32 keys each of the block's keys and read
// every tile in order.  Operand 2 i + {0, 1} is V, K (the block's rows) of
// the cluster's item i.  `db_partial` (2B, 3C): kDb only.
template <bool kDb>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kLongBwdWarps * 32, 1)
block_long_bwd_kernel(const __grid_constant__ CUtensorMap kv_map,
                      const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap probs_map, bf16* __restrict__ dqkv,
                      float* __restrict__ db_partial, int S, int C, int heads, int items,
                      int slots, int nstrips, float scale) {
  extern __shared__ __align__(1024) unsigned char block_long_bwd_smem[];
  constexpr int kQ = kLongQueryWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rank = cluster_rank(), peer = rank ^ 1;
  const int s_pad = (S + 15) & ~15;
  const int pairs = s_pad / 16;
  const int half = (pairs + 1) / 2;
  const int kj0 = rank == 0 ? 0 : half;
  const int kcnt = rank == 0 ? half : pairs - half;
  const int keys_left = S - 16 * kj0;  // the block's keys < S
  const int cluster = blockIdx.x >> 1, clusters = gridDim.x >> 1;
  const int mine = cluster < items ? (items - cluster + clusters - 1) / clusters : 0;
  WideRing strips{nullptr, nullptr, nullptr, nullptr, nullptr, nstrips, kLongStripElems,
                  kLongKeyWarps, mine * pairs};
  strips.init(block_long_bwd_smem);
  WideRing ring{nullptr, nullptr, nullptr, nullptr, nullptr, slots, half * 16 * 64, kQ, 2 * mine};
  ring.init(block_long_bwd_smem + nstrips * kLongStripBytes + kBlockWideStripBook);
  uint64_t* ds_full = reinterpret_cast<uint64_t*>(ring.released + kWideMaxSlots);
  uint64_t* dq_done = ds_full + kLongMaxStrips;
  uint64_t* dx_full = dq_done + kLongMaxStrips;
  uint64_t* qx_full = dx_full + kLongMaxStrips;
  uint64_t* mail_empty = qx_full + kLongMaxStrips;
  float* db_acc = reinterpret_cast<float*>(mail_empty + kLongMaxStrips);
  volatile int* q_turn = reinterpret_cast<volatile int*>(db_acc + 3 * 64);
  volatile int* k_turn = q_turn + 1;
  float* mail = db_acc + 3 * 64 + 4;
  auto load = [&](int n, bf16* dst, uint64_t* bar) {
    const int item = cluster + (n >> 1) * clusters;
    mbar_arrive_expect(bar, static_cast<uint32_t>(half * 16 * 64 * sizeof(bf16)));
    long_copy(dst, &kv_map, item % heads, (n & 1) ? 1 : 2, 16 * kj0, item / heads, bar);
  };
  const int boxes = (16 * kcnt + 63) / 64;
  auto load_strip = [&](int n, bf16* dst, uint64_t* bar) {
    const int i = n / pairs;
    const int item = cluster + i * clusters;
    const int r0 = (n - i * pairs) * 16;
    mbar_arrive_expect(bar, static_cast<uint32_t>((boxes * kProbsBoxElems + 2 * kLongRowTileElems) *
                                                  sizeof(bf16)));
    for (int c = 0; c < boxes; ++c)
      tma_load_probs(dst + c * kProbsBoxElems, &probs_map, 16 * kj0 + 64 * c, r0, item, bar);
    long_copy(dst + kLongStripQ, &q_map, item % heads, 0, r0, item / heads, bar);
    long_copy(dst + kLongStripDo, &do_map, item % heads, 0, r0, item / heads, bar);
  };
  if (threadIdx.x == 0) {
    ring.reset();
    strips.reset();
    for (int b = 0; b < nstrips; ++b) {
      mbar_init(ds_full + b, 32);
      mbar_init(dq_done + b, 32);
      mbar_init(dx_full + b, 32);
      mbar_init(qx_full + b, 32);
      mbar_init(mail_empty + b, 32);
    }
    *q_turn = 0;
    *k_turn = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Both blocks' barriers are set before either addresses the other's.
  cluster_sync_all();
  if (threadIdx.x == 0) {
    for (int n = 0; n < slots && n < ring.ops; ++n) {
      load(n, ring.tiles + n * ring.slot_elems, ring.full + n);
      ring.started[n] = n;
    }
    for (int n = 0; n < nstrips && n < strips.ops; ++n) {
      load_strip(n, strips.tiles + n * strips.slot_elems, strips.full + n);
      strips.started[n] = n;
    }
  }

  const int row3 = 3 * C;
  for (int i = 0; i < mine; ++i) {
    const int item = cluster + i * clusters;
    bf16* dhead = dqkv + static_cast<size_t>(item / heads) * S * row3 + (item % heads) * 64;
    float* db_out = kDb ? db_partial + static_cast<size_t>(2 * (item / heads) + rank) * 3 * C +
                              (item % heads) * 64
                        : nullptr;
    if (warp < kQ) {  // the query side: rows r0 .. r0 + 15 of its tiles
      const bf16* v_s = ring.acquire(2 * i);
      const bf16* k_s = ring.acquire(2 * i + 1);
      const int first = (warp - i * pairs % kQ + kQ) % kQ;  // < pairs: pairs >= 17
      float2 dq_sums = make_float2(0.f, 0.f);  // kDb: the column sums of this warp's tiles
      for (int tile = first; tile < pairs; tile += kQ) {
        const int n = i * pairs + tile;
        const int slot = n % nstrips;
        const int r0 = tile * 16;
        const bool last = tile + kQ >= pairs;
        bf16* p_s = const_cast<bf16*>(strips.acquire(n));
        bf16* ds_s = p_s + kLongStripDs;
        // dP = dO_t V^T over the block's keys, held.
        float dp[2 * kLongHalfPairs][4];
        block_scores<kLongHalfPairs>(dp, p_s + kLongStripDo, 0, v_s, kcnt, lane);
        if (last) ring.release(2 * i, lane, load);
        // delta's part over the block's keys, P rows r0 + g and r0 + g + 8.
        float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2 * kLongHalfPairs; ++nt) {
          if (nt < 2 * kcnt) {
            const uint32_t top = saved_pair(p_s, g, nt, t, keys_left);
            const uint32_t bottom = saved_pair(p_s, g + 8, nt, t, keys_left);
            dot0 += dp[nt][0] * bf16_lo(top) + dp[nt][1] * bf16_hi(top);
            dot1 += dp[nt][2] * bf16_lo(bottom) + dp[nt][3] * bf16_hi(bottom);
          }
        }
        dot0 = quad_sum(dot0);
        dot1 = quad_sum(dot1);
        // The slot's previous dS has been read for its dQ, and the other
        // block has read this block's mail of the slot's previous tile.
        if (n >= nstrips) {
          mbar_wait(dq_done + slot, (n / nstrips - 1) & 1);
          cluster_wait(mail_empty + slot, (n / nstrips - 1) & 1);
        }
        float* box = mail + slot * kLongMailFloats;
        const uint32_t peer_box = cluster_addr(box, peer);
        // delta = this block's part + the other's.
        if (t == 0) {
          cluster_store(peer_box + 4 * g, dot0);
          cluster_store(peer_box + 4 * (g + 8), dot1);
        }
        cluster_arrive(cluster_addr(dx_full + slot, peer));
        cluster_wait(dx_full + slot, (n / nstrips) & 1);
        dot0 += box[g];
        dot1 += box[g + 8];
        // dS = P (dP - delta), rounded to bf16 once, into the slot beside P.
#pragma unroll
        for (int j = 0; j < kLongHalfPairs; ++j) {
          if (j < kcnt) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int nt = 2 * j + hh;
              const uint32_t top = saved_pair(p_s, g, nt, t, keys_left);
              const uint32_t bottom = saved_pair(p_s, g + 8, nt, t, keys_left);
              dp[nt][0] = bf16_lo(top) * (dp[nt][0] - dot0);
              dp[nt][1] = bf16_hi(top) * (dp[nt][1] - dot0);
              dp[nt][2] = bf16_lo(bottom) * (dp[nt][2] - dot1);
              dp[nt][3] = bf16_hi(bottom) * (dp[nt][3] - dot1);
            }
            uint32_t dsa[4];
            wide_round_a(dsa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              *reinterpret_cast<uint32_t*>(probs_at(ds_s, g, 2 * j + hh) + 2 * t) = dsa[2 * hh];
              *reinterpret_cast<uint32_t*>(probs_at(ds_s, g + 8, 2 * j + hh) + 2 * t) =
                  dsa[2 * hh + 1];
            }
          }
        }
        mbar_arrive(ds_full + slot);
        __syncwarp();
        // dQ's part over the block's keys = dS K, dS's A fragments back from
        // the slot; then the dS half is free for the slot's next tile.
        float dq[8][4];
        wide_zero<64>(dq);
        for (int j = 0; j < kcnt; ++j) {
          uint32_t dsa[4];
          ldmatrix_x4(dsa, probs_at(ds_s, lane & 15, 2 * j + (lane >> 4)));
          block_accumulate(dq, dsa, k_s, 16 * j, lane);
        }
        if (last) ring.release(2 * i + 1, lane, load);
        __syncwarp();
        mbar_arrive(dq_done + slot);
        // The other block's columns (32 peer ..) to its mailbox; this block's
        // own = its part + the other's, the other columns 0 from here on.
        float* qbox = box + kLongMailDelta;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if ((nt >> 2) == peer) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cluster_store(peer_box + 4 * (kLongMailDelta + (4 * (nt & 3) + e) * 32 + lane),
                            dq[nt][e]);
          }
        }
        cluster_arrive(cluster_addr(qx_full + slot, peer));
        cluster_wait(qx_full + slot, (n / nstrips) & 1);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dq[nt][e] = (nt >> 2) == rank ? dq[nt][e] + qbox[(4 * (nt & 3) + e) * 32 + lane] : 0.f;
        __syncwarp();
        cluster_arrive(cluster_addr(mail_empty + slot, peer));
        uint32_t rounded[8][2];
        round_tile(dq, scale, rounded);
        const int q = r0 + g;
        bf16* prow = dhead + static_cast<size_t>(q) * row3 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if ((nt >> 2) == rank) {
            if (q < S) *reinterpret_cast<uint32_t*>(prow + nt * 8) = rounded[nt][0];
            if (q + 8 < S)
              *reinterpret_cast<uint32_t*>(prow + static_cast<size_t>(8) * row3 + nt * 8) =
                  rounded[nt][1];
          }
        }
        if constexpr (kDb) {
          const float2 sums = tile_column_sums(rounded, r0, S, lane);
          dq_sums.x += sums.x;
          dq_sums.y += sums.y;
        }
      }
      if constexpr (kDb) {  // the item's dq sums: query warp 0's, then 1's, 2's, 3's
        const int turn = i * kQ + warp;
        db_wait_turn(q_turn, turn);
        db_add(db_acc, warp == 0, warp == kQ - 1, dq_sums, db_out, lane);
        db_pass_turn(q_turn, turn, lane);
      }
    } else {  // the key side: the block's local key tiles 2 kw + kt, kt = 0, 1
      const int kw = warp - kQ;
      float dk[2][8][4], dv[2][8][4];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        wide_zero<64>(dk[kt]);
        wide_zero<64>(dv[kt]);
      }
      // For each tile of 16 queries: P^T and dS^T of the warp's keys, as A
      // fragments by ldmatrix.trans of the slot's rows (this lane addresses
      // query row fq), dV_t += P^T dO_t, dK_t += dS^T Q_t.  Queries >= S read
      // P and dS as 0; keys >= S are rows of dK and dV never stored.
      const int fq = (lane & 7) + ((lane >> 4) << 3);
      for (int tile = 0; tile < pairs; ++tile) {
        const int n = i * pairs + tile;
        const bf16* p_s = strips.acquire(n);
        mbar_wait(ds_full + n % nstrips, (n / nstrips) & 1);
        const bf16* ds_s = p_s + kLongStripDs;
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          const int lk = 2 * kw + kt;
          if (lk < kcnt) {
            const int c = 2 * lk + ((lane >> 3) & 1);
            uint32_t a[4];
            ldmatrix_x4_trans(a, probs_at(p_s, fq, c));
            block_accumulate(dv[kt], a, p_s + kLongStripDo, 0, lane);
            ldmatrix_x4_trans(a, probs_at(ds_s, fq, c));
            block_accumulate(dk[kt], a, p_s + kLongStripQ, 0, lane);
          }
        }
        strips.release(n, lane, load_strip);
      }
      // dK_t, dV_t rounded once and stored, tile by tile, with their column
      // sums (kDb).
      float2 dk_sums[2] = {}, dv_sums[2] = {};
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const int lk = 2 * kw + kt;
        if (lk < kcnt) {
          const int k0 = 16 * (kj0 + lk);
          uint32_t rounded[8][2];
          round_tile(dk[kt], scale, rounded);
          store_rounded_tile(rounded, dhead + C, row3, k0, S, lane);
          if constexpr (kDb) dk_sums[kt] = tile_column_sums(rounded, k0, S, lane);
          round_tile(dv[kt], 1.f, rounded);
          store_rounded_tile(rounded, dhead + 2 * C, row3, k0, S, lane);
          if constexpr (kDb) dv_sums[kt] = tile_column_sums(rounded, k0, S, lane);
        }
      }
      if constexpr (kDb) {
        const int turn = i * kLongKeyWarps + kw;
        db_wait_turn(k_turn, turn);
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          const int lk = 2 * kw + kt;
          if (lk < kcnt) {
            db_add(db_acc + 64, lk == 0, lk == kcnt - 1, dk_sums[kt], db_out + C, lane);
            db_add(db_acc + 128, lk == 0, lk == kcnt - 1, dv_sums[kt], db_out + 2 * C, lane);
          }
        }
        db_pass_turn(k_turn, turn, lane);
      }
    }
  }
  // Neither block leaves while the other may still address its mailboxes.
  cluster_sync_all();
}

// ---- launches -------------------------------------------------------------------

// A 5-d tensor map (d, head, which, row, sample) over a packed bf16 tensor
// (`which_n` blocks of C = 64 heads columns a row, `row` elements apart) whose
// box is `box_rows` rows of one head's 64 columns, 128-byte swizzled (a TMA
// box holds at most 256 rows).
inline cudaError_t long_tensor_map(CUtensorMap* map, const bf16* base, int which_n, int row,
                                   int batch, int seq, int heads, int box_rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const size_t elem = sizeof(bf16);
  const cuuint64_t dims[5] = {64, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(which_n), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[4] = {64 * elem, static_cast<cuuint64_t>(heads) * 64 * elem,
                                 static_cast<cuuint64_t>(row) * elem,
                                 static_cast<cuuint64_t>(seq) * row * elem};
  const cuuint32_t box[5] = {64, 1, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<bf16*>(base), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline bool long_takes(int seq, int width, int heads) {
  return width == heads * 64 && seq > kWideMaxSeq && seq <= kLongMaxSeq;
}

// Launch 3 of kernels 1 and 3 past the wide forms: qkv (B*S, 3C) -> out
// (B*S, C), heads of 64, 256 < S <= 512; probs (B, H, S, S16) with kSaveProbs.
// As many K / V slots as fit beside the Q slots, staging and exchange.
template <bool kSaveProbs, int kC>
cudaError_t launch_block_long_fwd_at(const bf16* qkv, bf16* out, bf16* probs, int batch,
                                     int seq, int width, int heads, float scale,
                                     cudaStream_t st) {
  const int s64 = 64 * kC;
  const int kv_bytes = s64 * 64 * static_cast<int>(sizeof(bf16));
  const int fixed = kLongQSlots * kLongTileBytes + (kSaveProbs ? kLongStageBytes : 0) +
                    2 * kWideSlotWords + kLongFwdXBytes;
  const int fit = (kWideSmemLimit - fixed) / kv_bytes;
  const int slots = fit < kWideMaxSlots ? fit : kWideMaxSlots;
  if (slots < 2) return cudaErrorInvalidValue;
  const int smem = fixed + slots * kv_bytes;
  auto kernel = block_long_fwd_kernel<kSaveProbs, kC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(batch * heads, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap kv_map, q_map;
  err = long_tensor_map(&kv_map, qkv, 3, 3 * width, batch, seq, heads, s64 / 2);
  if (err != cudaSuccess) return err;
  err = long_tensor_map(&q_map, qkv, 3, 3 * width, batch, seq, heads, 64);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kLongFwdThreads, smem, st>>>(kv_map, q_map, out, probs, seq, width, heads,
                                              batch * heads, slots, scale);
  return cudaGetLastError();
}

template <bool kSaveProbs>
cudaError_t launch_block_long_fwd(const bf16* qkv, bf16* out, bf16* probs, int batch, int seq,
                                  int width, int heads, float scale, cudaStream_t st) {
  if (!long_takes(seq, width, heads)) return cudaErrorInvalidValue;
  switch ((seq + 63) / 64) {
    case 5:
      return launch_block_long_fwd_at<kSaveProbs, 5>(qkv, out, probs, batch, seq, width, heads,
                                                     scale, st);
    case 6:
      return launch_block_long_fwd_at<kSaveProbs, 6>(qkv, out, probs, batch, seq, width, heads,
                                                     scale, st);
    case 7:
      return launch_block_long_fwd_at<kSaveProbs, 7>(qkv, out, probs, batch, seq, width, heads,
                                                     scale, st);
    case 8:
      return launch_block_long_fwd_at<kSaveProbs, 8>(qkv, out, probs, batch, seq, width, heads,
                                                     scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Kernels 4 (kDb) and 7 past the wide forms: qkv (B*S, 3C), probs (B, H, S,
// S16), dout (B*S, C) -> dqkv (B*S, 3C) [and db_partial (2B, 3C)], heads of
// 64, 256 < S <= 512.  The grid: as many clusters as are resident at once,
// at most one an item.
template <bool kDb>
cudaError_t launch_block_long_bwd(const bf16* qkv, const bf16* probs, const bf16* dout,
                                  bf16* dqkv, float* db_partial, int batch, int seq, int width,
                                  int heads, float scale, cudaStream_t st) {
  if (!long_takes(seq, width, heads)) return cudaErrorInvalidValue;
  const int s_pad = (seq + 15) & ~15;
  const int half = (s_pad / 16 + 1) / 2;
  const int tile = half * 16 * 64 * static_cast<int>(sizeof(bf16));
  // As many strip slots as fit beside four operand slots (two items' V and
  // K), at most eight; then as many operand slots as fit.
  const int room = kWideSmemLimit - kLongBwdFixedBytes;
  const int fit_strips = (room - 4 * tile) / kLongStripCost;
  const int nstrips = fit_strips < kLongMaxStrips ? fit_strips : kLongMaxStrips;
  const int fit = (room - nstrips * kLongStripCost) / tile;
  const int slots = fit < kWideMaxSlots ? fit : kWideMaxSlots;
  if (nstrips < kLongQueryWarps || slots < 2) return cudaErrorInvalidValue;
  const int smem = kLongBwdFixedBytes + nstrips * kLongStripCost + slots * tile;
  auto kernel = block_long_bwd_kernel<kDb>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2);
  config.blockDim = dim3(kLongBwdWarps * 32);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  if (clusters > batch * heads) clusters = batch * heads;
  CUtensorMap kv_map, q_map, do_map, probs_map;
  err = long_tensor_map(&kv_map, qkv, 3, 3 * width, batch, seq, heads, half * 16);
  if (err != cudaSuccess) return err;
  err = long_tensor_map(&q_map, qkv, 3, 3 * width, batch, seq, heads, 16);
  if (err != cudaSuccess) return err;
  err = long_tensor_map(&do_map, dout, 1, width, batch, seq, heads, 16);
  if (err != cudaSuccess) return err;
  err = probs_tensor_map(&probs_map, probs, seq, batch * heads);
  if (err != cudaSuccess) return err;
  kernel<<<2 * clusters, kLongBwdWarps * 32, smem, st>>>(kv_map, q_map, do_map, probs_map, dqkv,
                                                         db_partial, seq, width, heads,
                                                         batch * heads, slots, nstrips, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2
