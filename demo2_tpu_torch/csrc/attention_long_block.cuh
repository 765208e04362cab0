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
// kernels 4 and 7 move qkv, probs, dO and dqkv (1.83 GB, 0.5448 ms at 3.35
// TB/s) for 230.5 GFLOP: bytes.  Times: PERF.md §6.
//
// The design (the first long form; simple before fast):
//   * Forward (sixteen warps, four teams of four): a persistent block streams
//     16-row tasks, a task to a team.  K and V of an item come by TMA into a
//     ring of whole-head operand slots (two boxes of S16 / 2 rows each: a TMA
//     box holds at most 256 rows); Q's sixteen rows come from device memory
//     straight into each warp's A fragments.  Warp w of a team runs QK^T once
//     over its quarter of the key tiles (at most 8 of 32, 64 f32 a thread),
//     masks keys >= S by -inf, and the four quarters trade their row maxima
//     and sums through shared memory behind a named barrier a team; the sum is
//     ((s0 + s1) + s2) + s3 in every warp, so every rerun and both kernels add
//     alike.  expf once a score, the quotient, p rounded to bf16 once into the
//     team's P tile in shared memory (16 x S16, 64-column boxes under the
//     128-byte swizzle).  Then each warp computes 16 of O's 64 columns over
//     every key, P's A fragments back by ldmatrix: no partial O to add across
//     warps.  Kernel 3 copies the team's P tile to probs with 16-byte stores,
//     rows >= S left out.  Every element takes the same straight-line code.
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
// Measured: PERF.md §6.

#pragma once

#include "attention_wide_block.cuh"

namespace demo2 {
namespace {

constexpr int kLongMaxSeq = 512;
constexpr int kLongMaxPairs = kLongMaxSeq / 16;  // 16-row tiles of the longest sequence: 32
// The forward: sixteen warps (128 registers a thread), four to a task, each
// holding a quarter of the task's 16 x S16 scores: at most 8 key tiles.
constexpr int kLongFwdWarps = 16;
constexpr int kLongFwdTeams = kLongFwdWarps / 4;
constexpr int kLongQuarter = kLongMaxPairs / 4;
// A team's exchange: each quarter's row maxima and sums (16 rows each).
constexpr int kLongFwdXFloats = 2 * 4 * 16;
constexpr int kLongFwdXBytes = kLongFwdTeams * kLongFwdXFloats * 4;
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
static_assert(kWideSmemLimit - kWideSlotWords - kLongFwdXBytes -
                      kLongFwdTeams * 16 * kLongMaxSeq * 2 >=
                  2 * kLongMaxSeq * 64 * 2,
              "the forward's ring holds one item's K and V beside the teams' P tiles");

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

// Rows r0 .. r0 + 15 of one head's 64 columns, row stride `row`, as the A
// fragments of four 16-wide slices of d (rows >= S zero), read from device
// memory: a[kk] = {(g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)} of
// columns 16 kk ..
__device__ __forceinline__ void long_rows_a(uint32_t (&a)[4][4], const bf16* head, size_t row,
                                            int r0, int S, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool top = r0 + g < S, bottom = r0 + g + 8 < S;
  const bf16* p0 = head + static_cast<size_t>(r0 + g) * row + 2 * t;
  const bf16* p1 = p0 + 8 * row;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = top ? *reinterpret_cast<const uint32_t*>(p0 + 16 * kk) : 0u;
    a[kk][1] = bottom ? *reinterpret_cast<const uint32_t*>(p1 + 16 * kk) : 0u;
    a[kk][2] = top ? *reinterpret_cast<const uint32_t*>(p0 + 16 * kk + 8) : 0u;
    a[kk][3] = bottom ? *reinterpret_cast<const uint32_t*>(p1 + 16 * kk + 8) : 0u;
  }
}

// s (16 x 16 tiles, s[2 j + {0, 1}] the keys 16 j ..) = A B^T over the first
// `tiles` 16-row blocks of the operand tile B; A from registers (block_scores'
// products in its order).
template <int kTiles>
__device__ __forceinline__ void long_scores(float (&s)[2 * kTiles][4], const uint32_t (&a)[4][4],
                                            const bf16* b, int tiles, int lane) {
  const int x = lane & 7;
  const bf16* b_row = b + (((lane >> 4) << 3) + x) * 64;
#pragma unroll
  for (int nt = 0; nt < 2 * kTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* bk = b_row + (((2 * kk + ((lane >> 3) & 1)) ^ x) << 3);
#pragma unroll
    for (int np = 0; np < kTiles; ++np) {
      if (np < tiles) {
        uint32_t fb[4];
        ldmatrix_x4(fb, bk + np * 16 * 64);
        mma_bf16(s[2 * np], a[kk], fb[0], fb[1]);
        mma_bf16(s[2 * np + 1], a[kk], fb[2], fb[3]);
      }
    }
  }
}

// ---- the forward --------------------------------------------------------------------

// The four warps of team `team` (named barrier 1 + team).
__device__ __forceinline__ void long_team_sync(int team) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + team) : "memory");
}

// Persistent; task u is 16-row tile u % pairs of the block's item u / pairs;
// team m (warps 4 m .. 4 m + 3) takes tasks m, m + 4, ...; its quarter q
// (warp % 4) takes key tiles [j0, j0 + cnt), the tiles dealt out in order, the
// first pairs % 4 quarters one more.  Operand 2 i + {0, 1} is K, V of the
// block's item i.  `probs` (B, H, S, S16): kSaveProbs only.
template <bool kSaveProbs>
__global__ void __launch_bounds__(kLongFwdWarps * 32, 1)
block_long_fwd_kernel(const __grid_constant__ CUtensorMap map, const bf16* __restrict__ qkv,
                      bf16* __restrict__ out, bf16* __restrict__ probs, int S, int C, int heads,
                      int items, int slots, float scale) {
  extern __shared__ __align__(1024) unsigned char block_long_fwd_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int team = warp >> 2, quarter = warp & 3;
  const int s_pad = (S + 15) & ~15;
  const int pairs = s_pad / 16;
  const int j0 = quarter * (pairs / 4) + min(quarter, pairs % 4);
  const int cnt = pairs / 4 + (quarter < pairs % 4 ? 1 : 0);
  const int mine = block_items(items);
  const int box_rows = s_pad / 2;
  // The team's P tile: 16 rows of S16 columns in 64-column boxes.
  const int p_elems = (s_pad + 63) / 64 * kProbsBoxElems;
  bf16* p_tile = reinterpret_cast<bf16*>(block_long_fwd_smem) + team * p_elems;
  float* xm = reinterpret_cast<float*>(block_long_fwd_smem + kLongFwdTeams * p_elems * 2) +
              team * kLongFwdXFloats;
  float* xs = xm + 4 * 16;
  WideRing ring{nullptr, nullptr, nullptr, nullptr, nullptr, slots, s_pad * 64, 4 * pairs,
                2 * mine};
  ring.init(block_long_fwd_smem + kLongFwdTeams * p_elems * 2 + kLongFwdXBytes);
  auto load = [&](int n, bf16* dst, uint64_t* bar) {
    const int item = blockIdx.x + (n >> 1) * gridDim.x;
    const int which = 1 + (n & 1);
    mbar_arrive_expect(bar, static_cast<uint32_t>(s_pad * 64 * sizeof(bf16)));
    long_copy(dst, &map, item % heads, which, 0, item / heads, bar);
    long_copy(dst + box_rows * 64, &map, item % heads, which, box_rows, item / heads, bar);
  };
  if (threadIdx.x == 0) ring.reset();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int n = 0; n < slots && n < ring.ops; ++n) {
      load(n, ring.tiles + n * ring.slot_elems, ring.full + n);
      ring.started[n] = n;
    }
  }

  const size_t row3 = static_cast<size_t>(3) * C;
  for (int u = team; u < mine * pairs; u += kLongFwdTeams) {
    const int i = u / pairs;
    const int r0 = (u - i * pairs) * 16;
    const int item = blockIdx.x + i * gridDim.x;
    const int b = item / heads, h = item % heads;
    uint32_t qa[4][4];
    long_rows_a(qa, qkv + static_cast<size_t>(b) * S * row3 + h * 64, row3, r0, S, lane);
    // The one QK^T pass: this quarter's 16 x 16 cnt scores, held.
    const bf16* k_s = ring.acquire(2 * i);
    float s[2 * kLongQuarter][4];
    long_scores<kLongQuarter>(s, qa, k_s + j0 * 16 * 64, cnt, lane);
    ring.release(2 * i, lane, load);

    // s * scale (-inf at keys >= S: every element takes the same code), and
    // m = its maximum over the four quarters.
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2 * kLongQuarter; ++nt) {
      if (nt < 2 * cnt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = 16 * j0 + 8 * nt + 2 * t + (e & 1) < S ? __fmul_rn(s[nt][e], scale)
                                                             : -INFINITY;
        }
        m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
        m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    if (t == 0) {
      xm[16 * quarter + g] = m0;
      xm[16 * quarter + g + 8] = m1;
    }
    long_team_sync(team);
    m0 = fmaxf(fmaxf(xm[g], xm[16 + g]), fmaxf(xm[32 + g], xm[48 + g]));
    m1 = fmaxf(fmaxf(xm[g + 8], xm[24 + g]), fmaxf(xm[40 + g], xm[56 + g]));
    // e = expf(s * scale - m) in place, once a score; the row sum is
    // ((quarter 0's + 1's) + 2's) + 3's.
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * kLongQuarter; ++nt) {
      if (nt < 2 * cnt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(s[nt][e] - (e < 2 ? m0 : m1));
          s[nt][e] = x;
          if (e < 2) sum0 += x; else sum1 += x;
        }
      }
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    if (t == 0) {
      xs[16 * quarter + g] = sum0;
      xs[16 * quarter + g + 8] = sum1;
    }
    long_team_sync(team);
    const float d0 = (((xs[g] + xs[16 + g]) + xs[32 + g]) + xs[48 + g]) + 1e-30f;
    const float d1 = (((xs[g + 8] + xs[24 + g]) + xs[40 + g]) + xs[56 + g]) + 1e-30f;
    const float rd0 = 1.f / d0, rd1 = 1.f / d1;

    // p = e / (sum + 1e-30), rounded to bf16 once, into the team's P tile.
#pragma unroll
    for (int j = 0; j < kLongQuarter; ++j) {
      if (j < cnt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int nt = 2 * j + hh;
          const int c = 2 * (j0 + j) + hh;
          *reinterpret_cast<uint32_t*>(probs_at(p_tile, g, c) + 2 * t) =
              pack_bf16x2(wide_quotient(s[nt][0], d0, rd0), wide_quotient(s[nt][1], d0, rd0));
          *reinterpret_cast<uint32_t*>(probs_at(p_tile, g + 8, c) + 2 * t) =
              pack_bf16x2(wide_quotient(s[nt][2], d1, rd1), wide_quotient(s[nt][3], d1, rd1));
        }
      }
    }
    long_team_sync(team);
    if constexpr (kSaveProbs) {
      // The team's P rows r0 .. r0 + 15 (those < S) to probs, 16 bytes a
      // thread a step.
      const int chunks = s_pad >> 3;
      bf16* dst = probs + (static_cast<size_t>(item) * S + r0) * s_pad;
      for (int k = quarter * 32 + lane; k < 16 * chunks; k += 128) {
        const int row = k / chunks;
        const int c = k - row * chunks;
        if (r0 + row < S)
          *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * s_pad + 8 * c) =
              *reinterpret_cast<const uint4*>(probs_at(p_tile, row, c));
      }
    }

    // O's columns 16 quarter .. + 15 = P V over every key, P's A fragments
    // back from the team's tile.
    const bf16* v_s = ring.acquire(2 * i + 1);
    float o[2][4] = {};
    const int x = lane & 7;
    const bf16* v_row = v_s + (x + ((lane >> 3) & 1) * 8) * 64 +
                        (((2 * quarter + (lane >> 4)) ^ x) << 3);
    for (int j = 0; j < pairs; ++j) {
      uint32_t a[4], fb[4];
      ldmatrix_x4(a, probs_at(p_tile, lane & 15, 2 * j + (lane >> 4)));
      ldmatrix_x4_trans(fb, v_row + j * 16 * 64);
      mma_bf16(o[0], a, fb[0], fb[1]);
      mma_bf16(o[1], a, fb[2], fb[3]);
    }
    ring.release(2 * i + 1, lane, load);
    bf16* dst = out + static_cast<size_t>(b) * S * C + h * 64 + 16 * quarter + 2 * t;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (r0 + g < S)
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r0 + g) * C + 8 * q) =
            pack_bf16x2(o[q][0], o[q][1]);
      if (r0 + g + 8 < S)
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r0 + g + 8) * C + 8 * q) =
            pack_bf16x2(o[q][2], o[q][3]);
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
template <bool kSaveProbs>
cudaError_t launch_block_long_fwd(const bf16* qkv, bf16* out, bf16* probs, int batch, int seq,
                                  int width, int heads, float scale, cudaStream_t st) {
  if (!long_takes(seq, width, heads)) return cudaErrorInvalidValue;
  const int s_pad = (seq + 15) & ~15;
  const int tile = s_pad * 64 * static_cast<int>(sizeof(bf16));
  const int p_bytes = (s_pad + 63) / 64 * kProbsBoxElems * static_cast<int>(sizeof(bf16));
  const int fixed = kLongFwdTeams * p_bytes + kLongFwdXBytes;
  const int fit = (kWideSmemLimit - kWideSlotWords - fixed) / tile;
  const int slots = fit < kWideMaxSlots ? fit : kWideMaxSlots;
  if (slots < 2) return cudaErrorInvalidValue;
  const int smem = fixed + slots * tile + kWideSlotWords;
  auto kernel = block_long_fwd_kernel<kSaveProbs>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(batch * heads, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = long_tensor_map(&map, qkv, 3, 3 * width, batch, seq, heads, s_pad / 2);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kLongFwdWarps * 32, smem, st>>>(map, qkv, out, probs, seq, width, heads,
                                                 batch * heads, slots, scale);
  return cudaGetLastError();
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
