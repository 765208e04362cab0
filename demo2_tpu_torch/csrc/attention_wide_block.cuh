// The block kernels' attention past the register tiles: heads of 64 over up
// to 256 tokens (the CLIP flagship at MODEL.STRIDE_SIZE (12, 12), 211 tokens
// at 256x128, or at 384x128, 193 tokens).  attention_regs_fwd.cuh and
// attention_regs_bwd.cuh hold a whole score row, and kernel 4 a whole saved P
// of one head, for at most 144 tokens; the wrappers send the longer
// sequences here (ops/packed_attention.py::regs_take).
//
//   block_wide_fwd_kernel<kSaveProbs>: launch 3 of kernels 1 and 3
//       (fused_attention_block.cu), the attention of demo2_tpu/ops/
//       fused_block.py::_fwd_kernel_core (kernel 1 :128, pallas_call :218;
//       kernel 3 :118, pallas_call :164) in its rounding mode
//       (Softmax::kNormBeforePV): s = (q k^T) * scale in f32, keys >= S left
//       out, p = expf(s - rowmax) / (rowsum + 1e-30) in f32, rounded to bf16
//       once, o = bf16(p_bf16 v) with f32 accumulation.  Kernel 3's form
//       also stores that very bf16 p into probs (B, H, S, S16), columns >= S
//       zero (ops/packed_attention.py's layout).
//   block_wide_bwd_kernel<kDb>: kernels 4 (kDb) and 7, and so the first
//       stage of kernel 8 (attention_bwd.cu), replacing demo2_tpu/ops/
//       packed_attention.py::_bwd_saved_db_kernel (:264, pallas_call :338)
//       and ::_bwd_saved_kernel (:231, pallas_call :508) in their rounding
//       mode (Probs::kSaved): P the saved bf16 p, not recomputed;
//       dV = P^T dO, dP = dO V^T, dS = bf16(P (dP - rowsum(dP P))),
//       dQ = dS K * scale, dK = dS^T Q * scale, each rounded to bf16 once;
//       with kDb the f32 column sums of the rounded dq, dk, dv per sample
//       into db_partial (B, 3C), added in a fixed order (no atomics), which
//       attention_bwd.cu's db_reduce_kernel then adds over the samples.
//       Kernel 7 is the same instantiation with the sums compiled out, so its
//       dqkv equals kernel 4's bit for bit.
//
// p is computed by the plain versions' operations (expf, the scale by an
// unfused multiply, each division by its correctly rounding fast path:
// wide_quotient), not by the exp2 / reciprocal form, which passed every bound
// and still broke the flagship's training (attention_regs_fwd.cuh,
// softmax_rows_exact).
//
// What bounds them on an H100: at x (192, 211, 768), 12 heads of 64, the
// attention alone must move qkv (186.7 MB), attn (62.2 MB) and, in kernel 3,
// the probs (217.8 MB): 0.139 ms at 3.35 TB/s, for 26.3 GFLOP (0.027 ms at
// 989 TFLOP/s); kernels 4 and 7 move qkv, probs, dO and dqkv (653 MB, 0.195
// ms) for 52.5 GFLOP.  Bytes bound both.  Kernels 1 and 3 as a whole (LN,
// the qkv and out-proj GEMMs on gemm_sm90.cuh, this attention) are bound by
// operations: 0.2198 ms.  Times: PERF.md §6.
//
// The design (the second; the first ran QK^T three times a task and
// expf twice a score in the forward, and in the backward read P from device
// memory twice, as 4-byte rows and 2-byte columns, and computed dP three
// times):
//   * Forward (sixteen warps, 128 registers a thread): the wide pair's TMA
//     ring of S16 x 64 operand tiles (attention_wide.cuh) and persistent
//     stream of 16-row tasks, a task to a team of two warps.  Each half of
//     a team runs QK^T once over its half of the keys (7 of 14 tiles at 211
//     tokens) and holds those scores (56 registers), masks keys >= S by
//     -inf, takes the row maximum, expf once a score in place (expf(-inf) =
//     0), the row sum, the quotient by the correctly rounded reciprocal and
//     one fma (wide_quotient), rounds p to bf16 once and feeds those
//     registers to PV as its A fragments.  The halves trade their row maxima
//     and sums through shared memory (the row sum is half 0's plus half
//     1's), and their partial O (O = half 0's + half 1's, each half storing
//     32 columns), behind a named barrier a team.  Every element takes the
//     same straight-line code: with a branch on keys >= S at each element the
//     same design read 0.82 / 0.95 ms (kernels 1 / 3) against 0.64 / 0.68.
//     Kernel 3 writes its bf16 p into the warp's staging tile (16 x 16 boxes
//     of plain rows) and copies it to probs with 16-byte stores, rows >= S
//     left out; TMA stores of the same boxes, or of 64-column boxes a team,
//     cost 0.13-0.16 ms more a call where these cost 0.03.
//   * Backward (twelve warps, two roles, no block barrier after the start): a
//     block's items are one stream of 16-row tiles, n = i pairs + tile.  Four
//     query warps take the tiles in turn (warp w the tiles n = w mod 4),
//     eight key warps own 32 keys each of every item.  P comes in once, tile
//     by tile, by TMA (16 rows x 64-column boxes, rows >= S zero) into a ring
//     of strip slots of 16 KB (six at 211 tokens: as many as fit beside four
//     operand slots; fewer read slower, PERF.md §6): P beside the bf16 dS
//     computed from it.  A query warp computes dP = dO_t V^T over every key
//     once and holds it, delta = rowsum(dP P) from P's rows in the slot
//     (conflict-free 4-byte reads), dS = P (dP - delta) rounded to bf16 once
//     into the slot, an arrival on the slot's dS barrier, then dQ_t = dS K
//     with dS's A fragments back from the slot, then an arrival on the slot's
//     dQ barrier.  A key warp takes the item's tiles in order: P^T and dS^T
//     of its keys as A fragments by ldmatrix.trans of the slot's rows, dV +=
//     P^T dO, dK += dS^T Q, then releases the slot, and the eighth release
//     asks the copy engine for tile n + slots.  The dS half is the query
//     side's alone: the query warp of tile n + slots (another warp) waits on
//     the dQ barrier before it writes its dS, so dQ never reads a dS
//     overwritten under it, and the next P's copy waits for the key warps
//     only (the query warp's release of the slot after its dQ read 0.70 ms
//     for kernel 4 against this 0.63).  So P leaves device memory once, dP is
//     computed once, and dK is taken from the very dS that dQ is.  K, Q, V
//     and dO of each item are the operand ring's (V, dO, K, Q in that order,
//     each released by all twelve warps).  Every wait is for a tile or
//     operand whose producers depend on nothing later, so none can form a
//     cycle.  db: each query warp sums the rounded dq tiles it took, in tile
//     order, and the four partials are added in warp order; the dk, dv tiles'
//     sums in key-warp order; each chain behind its own turn (no atomics).
//   * Held rows are sized by the longest sequence an instantiation takes:
//     kPairs = 14 (S <= 224, every configuration's) or 16 tiles, so each
//     kernel is built twice.  One 16-tile build at 211 tokens read 0.68 /
//     0.74 / 0.80 / 0.72 ms (kernels 1 / 3 / 4 / 7) against 0.65 / 0.68 /
//     0.71 / 0.56: it spills more.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, tools/compare_trees.py in turns at
// x (192, 211, 768) against the first design, PERF.md §6): kernels 1 / 3 / 4 /
// 7 0.649 / 0.680 / 0.631 / 0.567 ms against 0.757 / 0.804 / 0.923 / 0.921,
// 34 / 32 / 31 / 34% of their bounds.  One warp holding the whole 16 x S16
// row read 1.22 / 1.58 ms (kernels 1 / 3) at twelve warps, which spill, and
// 1.02 / 1.04 at eight.  Resources (nvcc -Xptxas -v, sm_90a; phase 1 of
// chip_smoke.py prints them): the forward 128 registers, no spill at
// kPairs = 14 (20 bytes at 16); the backward 168, 4 / 16 bytes of spill
// stores (kernels 7 / 4) at 14, 36 / 52 at 16.

#pragma once

#include "attention_regs_bwd.cuh"
#include "attention_wide.cuh"

namespace demo2 {
namespace {

// Tiles of 16 rows a head: the held rows are sized by the longest sequence
// a kernel instantiation takes, 14 (S <= 224: every configuration's) or 16
// (the 16-tile build alone spills more and read 5-27% slower at 211 tokens).
constexpr int kBlockWidePairsShort = 14;
// The forward: sixteen warps (128 registers a thread), two to a task, each
// holding half of the task's 16 x S16 scores.
constexpr int kBlockWideFwdWarps = 16;
constexpr int kBlockWideFwdTeams = kBlockWideFwdWarps / 2;
// A team's exchange: each half's row maxima and sums (16 rows each) and the
// half of its O that the other half stores (16 x 32 f32 in the accumulator
// layout, [element][lane]).
constexpr int kBlockWideFwdXFloats = 2 * 16 + 2 * 16 + 2 * 16 * 32;
constexpr int kBlockWideFwdXBytes = kBlockWideFwdTeams * kBlockWideFwdXFloats * 4;
constexpr int kBlockWideQueryWarps = 4;  // the backward's query side
constexpr int kBlockWideKeyWarps = 8;    // its key side: 32 keys each, 256 in all
constexpr int kBlockWideBwdWarps = kBlockWideQueryWarps + kBlockWideKeyWarps;
// A tile of 16 rows of P (or of kernel 3's p, or of dS) over up to 256
// columns: four boxes of 16 x 64 bf16 in 128-byte rows under the 128-byte
// swizzle, the layout of one TMA box of the probs tensor map.
constexpr int kProbsBoxElems = 16 * 64;
constexpr int kProbsTileElems = 4 * kProbsBoxElems;
constexpr int kProbsTileBytes = kProbsTileElems * static_cast<int>(sizeof(bf16));
// The forward's staging tiles for kernel 3's probs, one a warp: its 16 rows
// of up to eight 16-column boxes in plain rows.
constexpr int kStoreBoxElems = 16 * 16;
constexpr int kBlockWideFwdStageBytes =
    kBlockWideFwdWarps * (kWideMaxPairs / 2) * kStoreBoxElems * static_cast<int>(sizeof(bf16));
static_assert(kBlockWideFwdXBytes % 1024 == 0, "the operand ring starts on 1,024 bytes");
// The backward's strip ring: a slot holds one 16-row tile of P and the dS
// the query side computes from it; as many slots as fit beside four operand
// slots, at most eight; its words, rounded up so that the operand ring after
// it starts on 1,024 bytes.
constexpr int kBlockWideMaxStrips = 8;
constexpr int kBlockWideStripSlotBytes = 2 * kProbsTileBytes;
constexpr int kBlockWideStripBook = 2048;
static_assert(kWideSlotWords <= kBlockWideStripBook, "the strip ring's words fit its room");
// After the operand ring's words: a dS barrier and a dQ barrier a strip
// slot, the db accumulator (dq | dk | dv, 64 floats each) and the two turns
// of its sums.
constexpr int kBlockWideBwdWords = 2 * kBlockWideMaxStrips * 8 + 3 * 64 * 4 + 16;
constexpr int kBlockWideBwdFixedBytes =
    kBlockWideStripBook + kWideSlotWords + kBlockWideBwdWords;
static_assert(kWideSmemLimit - kBlockWideBwdFixedBytes - 4 * kWideMaxSeq * 64 * 2 >=
                  kBlockWideQueryWarps * kBlockWideStripSlotBytes,
              "one item's K, Q, V and dO and a strip slot a query warp fit at the longest S");
static_assert(kWideSmemLimit - kWideSlotWords - kBlockWideFwdStageBytes - kBlockWideFwdXBytes >=
                  3 * kWideMaxSeq * 64 * 2,
              "kernel 3's ring holds one item's Q, K and V beside the staging tiles");

// Element (r, 8 c) of a probs tile (c the 8-column chunk of the row, 0-31).
__device__ __forceinline__ bf16* probs_at(bf16* tile, int r, int c) {
  return swizzled(tile + (c >> 3) * kProbsBoxElems, r, c & 7);
}
__device__ __forceinline__ const bf16* probs_at(const bf16* tile, int r, int c) {
  return swizzled(tile + (c >> 3) * kProbsBoxElems, r, c & 7);
}

// One lane: the 16 x 64 box of probs (B*H, S, S16) at columns col.., rows
// row.. of item `item` to dst (rows >= S and columns >= S16 zero), counted on
// `bar`.
__device__ __forceinline__ void tma_load_probs(bf16* dst, const CUtensorMap* map, int col,
                                               int row, int item, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(item), "r"(smem_u32(bar))
      : "memory");
}
// The products of attention_wide.cuh's wide_scores_all and wide_accumulate
// at D = 64, with each lane's row and swizzled chunks taken once: a row's
// swizzle (r % 8) is lane % 8 in every 16-row block, so one block differs
// from the next by a constant offset and the addresses cost few registers
// beside a held 16 x S16 row.  The same products in the same order.
//   s (16 x S16, s[2 j + {0, 1}] the columns 16 j ..) = A[r0 .. r0 + 15] B^T
//   over the first `pairs` 16-row blocks of B, both operand tiles.
template <int kPairs>
__device__ __forceinline__ void block_scores(float (&s)[2 * kPairs][4], const bf16* a, int r0,
                                             const bf16* b, int pairs, int lane) {
  const int x = lane & 7;
  const bf16* a_row = a + (r0 + (lane & 15)) * 64;
  const bf16* b_row = b + (((lane >> 4) << 3) + x) * 64;
#pragma unroll
  for (int nt = 0; nt < 2 * kPairs; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t fa[4];
    ldmatrix_x4(fa, a_row + (((2 * kk + (lane >> 4)) ^ x) << 3));
    const bf16* bk = b_row + (((2 * kk + ((lane >> 3) & 1)) ^ x) << 3);
#pragma unroll
    for (int np = 0; np < kPairs; ++np) {
      if (np < pairs) {
        uint32_t fb[4];
        ldmatrix_x4(fb, bk + np * 16 * 64);
        mma_bf16(s[2 * np], fa, fb[0], fb[1]);
        mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  }
}
//   acc (16 x 64) += a (16 x 16) B[k0 .. k0 + 15, :], B an operand tile [k][n].
__device__ __forceinline__ void block_accumulate(float (&acc)[8][4], const uint32_t (&a)[4],
                                                 const bf16* b, int k0, int lane) {
  const int x = lane & 7;
  const bf16* row = b + (k0 + x + ((lane >> 3) & 1) * 8) * 64;
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t fb[4];
    ldmatrix_x4_trans(fb, row + (((2 * dp + (lane >> 4)) ^ x) << 3));
    mma_bf16(acc[2 * dp], a, fb[0], fb[1]);
    mma_bf16(acc[2 * dp + 1], a, fb[2], fb[3]);
  }
}

// ---- the forward --------------------------------------------------------------

// The two warps of team `team` (named barrier 1 + team).
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + team) : "memory");
}

// Persistent; task u is 16-row tile u % pairs of the block's item u / pairs,
// team m (warps 2 m, 2 m + 1) takes tasks m, m + 8, ...; its half h takes
// the task's key tiles [j0, j0 + cnt): the first ceil(pairs / 2) for h = 0,
// the rest for h = 1.  Operand 3 i + {0, 1, 2} is Q, K, V of the block's
// item i.  `probs` (B, H, S, S16): kSaveProbs only.  pairs <= 2 kHalf.
template <bool kSaveProbs, int kHalf>
__global__ void __launch_bounds__(kBlockWideFwdWarps * 32, 1)
block_wide_fwd_kernel(const __grid_constant__ CUtensorMap map, bf16* __restrict__ out,
                      bf16* __restrict__ probs, int S, int C, int heads, int items, int slots,
                      float scale) {
  extern __shared__ __align__(1024) unsigned char block_wide_fwd_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int team = warp >> 1, half = warp & 1;
  const int s_pad = (S + 15) & ~15;
  const int pairs = s_pad / 16;
  const int j0 = half == 0 ? 0 : (pairs + 1) / 2;
  const int cnt = half == 0 ? (pairs + 1) / 2 : pairs / 2;
  const int mine = block_items(items);
  constexpr int kStage = kSaveProbs ? kBlockWideFwdStageBytes : 0;
  bf16* stage = reinterpret_cast<bf16*>(block_wide_fwd_smem) +
                warp * (kWideMaxPairs / 2) * kStoreBoxElems;
  float* xm = reinterpret_cast<float*>(block_wide_fwd_smem + kStage) + team * kBlockWideFwdXFloats;
  float* xs = xm + 2 * 16;
  float* xo = xs + 2 * 16;
  WideRing ring{nullptr, nullptr, nullptr, nullptr, nullptr, slots, s_pad * 64, 2 * pairs,
                3 * mine};
  ring.init(block_wide_fwd_smem + kStage + kBlockWideFwdXBytes);
  auto load = [&](int n, bf16* dst, uint64_t* bar) {
    const int item = blockIdx.x + (n / 3) * gridDim.x;
    wide_load<64>(dst, s_pad, &map, &map, item % heads, n % 3, item / heads, bar);
  };
  if (threadIdx.x == 0) ring.reset();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int n = 0; n < slots && n < ring.ops; ++n) {
      load(n, ring.tiles + n * ring.slot_elems, ring.full + n);
      ring.started[n] = n;
    }
  }

  for (int u = team; u < mine * pairs; u += kBlockWideFwdTeams) {
    const int i = u / pairs;
    const int r0 = (u - i * pairs) * 16;
    const int item = blockIdx.x + i * gridDim.x;
    const bf16* q_s = ring.acquire(3 * i);
    const bf16* k_s = ring.acquire(3 * i + 1);
    // The one QK^T pass: this half's 16 x 16 cnt scores, held.
    float s[2 * kHalf][4];
    block_scores<kHalf>(s, q_s, r0, k_s + j0 * 16 * 64, cnt, lane);
    ring.release(3 * i, lane, load);

    // s * scale (-inf at keys >= S, so that each element below takes the
    // same straight-line code), and m = its maximum, over both halves.
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2 * kHalf; ++nt) {
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
      xm[16 * half + g] = m0;
      xm[16 * half + g + 8] = m1;
    }
    team_sync(team);
    m0 = fmaxf(xm[g], xm[16 + g]);
    m1 = fmaxf(xm[g + 8], xm[16 + g + 8]);
    // e = expf(s * scale - m) in place, once a score (expf(-inf) = 0 at
    // keys >= S); the row sum is half 0's sum plus half 1's.
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * kHalf; ++nt) {
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
      xs[16 * half + g] = sum0;
      xs[16 * half + g + 8] = sum1;
    }
    team_sync(team);
    const float d0 = (xs[g] + xs[16 + g]) + 1e-30f, d1 = (xs[g + 8] + xs[16 + g + 8]) + 1e-30f;
    const float rd0 = 1.f / d0, rd1 = 1.f / d1;

    // p = e / (sum + 1e-30), rounded to bf16 once: the A fragments of PV
    // and, in kernel 3, the probs rows r0 .. r0 + 15.
    uint32_t pa[kHalf][4];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      if (j < cnt) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool lo = e < 2;
            s[2 * j + h][e] = wide_quotient(s[2 * j + h][e], lo ? d0 : d1, lo ? rd0 : rd1);
          }
        wide_round_a(pa[j], s[2 * j], s[2 * j + 1]);
      }
    }
    if constexpr (kSaveProbs) {
      // This half's p through the warp's staging tile (16 x 16 boxes of
      // plain rows) to probs rows r0 .. r0 + 15 (those < S): 16 bytes a lane.
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        if (j < cnt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bf16* box = stage + j * kStoreBoxElems + 8 * h + 2 * t;
            *reinterpret_cast<uint32_t*>(box + g * 16) = pa[j][2 * h];
            *reinterpret_cast<uint32_t*>(box + (g + 8) * 16) = pa[j][2 * h + 1];
          }
        }
      }
      __syncwarp();
      const int row = r0 + (lane >> 1);
      bf16* prow = probs + (static_cast<size_t>(item) * S + row) * s_pad + 16 * j0 + 8 * (lane & 1);
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        if (j < cnt && row < S) {
          *reinterpret_cast<uint4*>(prow + 16 * j) =
              *reinterpret_cast<const uint4*>(stage + j * kStoreBoxElems + 8 * lane);
        }
      }
    }

    // This half's PV; O = half 0's + half 1's, half h storing columns
    // 32 h .. 32 h + 31.
    const bf16* v_s = ring.acquire(3 * i + 2);
    float o[8][4];
    wide_zero<64>(o);
#pragma unroll
    for (int j = 0; j < kHalf; ++j)
      if (j < cnt) block_accumulate(o, pa[j], v_s, 16 * (j0 + j), lane);
    ring.release(3 * i + 1, lane, load);
    ring.release(3 * i + 2, lane, load);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xo[(16 * half + 4 * q + e) * 32 + lane] = half == 0 ? o[4 + q][e] : o[q][e];
    team_sync(team);
    bf16* dst = out + static_cast<size_t>(item / heads) * S * C + (item % heads) * 64;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (half == 0 ? o[q][e] : o[4 + q][e]) + xo[(16 * (1 - half) + 4 * q + e) * 32 + lane];
      const int col = 32 * half + 8 * q + 2 * t;
      if (r0 + g < S)
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r0 + g) * C + col) =
            pack_bf16x2(v[0], v[1]);
      if (r0 + g + 8 < S)
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r0 + g + 8) * C + col) =
            pack_bf16x2(v[2], v[3]);
    }
  }
}

// ---- the backward -------------------------------------------------------------

// Two saved bf16 p of row r of a P tile, columns 8 nt + 2 t and + 1, as one
// register (the first in the low half); 0 at columns >= S.
__device__ __forceinline__ uint32_t saved_pair(const bf16* tile, int r, int nt, int t, int S) {
  const int col = 8 * nt + 2 * t;
  const uint32_t w = *reinterpret_cast<const uint32_t*>(probs_at(tile, r, nt) + 2 * t);
  return col + 1 < S ? w : col < S ? (w & 0xffffu) : 0u;
}

// Persistent, with two roles.  Warps 0-3, the query side, take the block's
// 16-row tiles n = 0, 1, ... in turn (n = i pairs + tile: tile `tile` of
// the block's item i), warp w the tiles n = w mod 4, tile n in strip slot
// n mod nstrips;
// warps 4-11, the key side, own keys 32 (w - 4) .. + 31 of every item and
// read every tile in order.  Operand 4 i + {0, 1, 2, 3} is V, dO, K, Q of
// the block's item i.  `db_partial` (B, 3C): kDb only.  S16 <= 16 kPairs.
template <bool kDb, int kPairs>
__global__ void __launch_bounds__(kBlockWideBwdWarps * 32, 1)
block_wide_bwd_kernel(const __grid_constant__ CUtensorMap qkv_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap probs_map, bf16* __restrict__ dqkv,
                      float* __restrict__ db_partial, int S, int C, int heads, int items,
                      int slots, int nstrips, float scale) {
  extern __shared__ __align__(1024) unsigned char block_wide_bwd_smem[];
  constexpr int kOpV = 0, kOpDo = 1, kOpK = 2, kOpQ = 3;
  constexpr int kQ = kBlockWideQueryWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s_pad = (S + 15) & ~15;
  const int pairs = s_pad / 16;
  const int mine = block_items(items);
  // Tile n of P in strip slot n % nstrips, released by the eight key warps.
  // Its dS half is the query side's: the query warp of tile n writes it once
  // the query warp of tile n - nstrips has read it back for its dQ
  // (dq_done), so the copy of the next P never waits for a dQ.
  WideRing strips{nullptr, nullptr, nullptr, nullptr, nullptr, nstrips, 2 * kProbsTileElems,
                  kBlockWideKeyWarps, mine * pairs};
  strips.init(block_wide_bwd_smem);
  WideRing ring{nullptr, nullptr, nullptr, nullptr, nullptr, slots, s_pad * 64, kBlockWideBwdWarps,
                4 * mine};
  ring.init(block_wide_bwd_smem + nstrips * kBlockWideStripSlotBytes + kBlockWideStripBook);
  uint64_t* ds_full = reinterpret_cast<uint64_t*>(ring.released + kWideMaxSlots);
  uint64_t* dq_done = ds_full + kBlockWideMaxStrips;
  float* db_acc = reinterpret_cast<float*>(dq_done + kBlockWideMaxStrips);
  volatile int* q_turn = reinterpret_cast<volatile int*>(db_acc + 3 * 64);
  volatile int* k_turn = q_turn + 1;
  auto load = [&](int n, bf16* dst, uint64_t* bar) {
    const int item = blockIdx.x + (n / 4) * gridDim.x;
    const int op = n % 4;
    if (op == kOpDo) {
      wide_load<64>(dst, s_pad, &do_map, &do_map, item % heads, 0, item / heads, bar);
    } else {
      wide_load<64>(dst, s_pad, &qkv_map, &qkv_map, item % heads,
                    op == kOpQ ? 0 : op == kOpK ? 1 : 2, item / heads, bar);
    }
  };
  auto load_strip = [&](int n, bf16* dst, uint64_t* bar) {
    const int i = n / pairs;
    const int item = blockIdx.x + i * gridDim.x;
    const int r0 = (n - i * pairs) * 16;
    mbar_arrive_expect(bar, static_cast<uint32_t>((s_pad + 63) / 64 * kProbsBoxElems * 2));
    for (int c = 0; c < s_pad; c += 64)
      tma_load_probs(dst + (c >> 6) * kProbsBoxElems, &probs_map, c, r0, item, bar);
  };
  if (threadIdx.x == 0) {
    ring.reset();
    strips.reset();
    for (int b = 0; b < nstrips; ++b) {
      mbar_init(ds_full + b, 32);
      mbar_init(dq_done + b, 32);
    }
    *q_turn = 0;
    *k_turn = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
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
    const int item = blockIdx.x + i * gridDim.x;
    const int op0 = 4 * i;
    bf16* dhead = dqkv + static_cast<size_t>(item / heads) * S * row3 + (item % heads) * 64;
    float* db_out = kDb ? db_partial + static_cast<size_t>(item / heads) * 3 * C +
                              (item % heads) * 64
                        : nullptr;
    if (warp < kQ) {  // the query side: rows r0 .. r0 + 15 of its tiles
      const bf16* v_s = ring.acquire(op0 + kOpV);
      const bf16* do_s = ring.acquire(op0 + kOpDo);
      const int first = (warp - i * pairs % kQ + kQ) % kQ;
      float2 dq_sums = make_float2(0.f, 0.f);  // kDb: the column sums of this warp's tiles
      if (first >= pairs) {
        ring.release(op0 + kOpV, lane, load);
        ring.release(op0 + kOpDo, lane, load);
      }
      for (int tile = first; tile < pairs; tile += kQ) {
        const int n = i * pairs + tile;
        const int r0 = tile * 16;
        // dP = dO_t V^T over every key, held.
        float dp[2 * kPairs][4];
        block_scores<kPairs>(dp, do_s, r0, v_s, pairs, lane);
        if (tile + kQ >= pairs) {
          ring.release(op0 + kOpV, lane, load);
          ring.release(op0 + kOpDo, lane, load);
        }
        bf16* p_s = const_cast<bf16*>(strips.acquire(n));
        bf16* ds_s = p_s + kProbsTileElems;
        // delta = rowsum(dP P), P rows r0 + g (top) and r0 + g + 8.
        float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2 * kPairs; ++nt) {
          if (nt < 2 * pairs) {
            const uint32_t top = saved_pair(p_s, g, nt, t, S);
            const uint32_t bottom = saved_pair(p_s, g + 8, nt, t, S);
            dot0 += dp[nt][0] * bf16_lo(top) + dp[nt][1] * bf16_hi(top);
            dot1 += dp[nt][2] * bf16_lo(bottom) + dp[nt][3] * bf16_hi(bottom);
          }
        }
        dot0 = quad_sum(dot0);
        dot1 = quad_sum(dot1);
        // dS = P (dP - delta), rounded to bf16 once, into the slot beside P
        // for the key side's dK and this tile's dQ, once the slot's previous
        // dS has been read for its dQ.
        if (n >= nstrips) mbar_wait(dq_done + n % nstrips, (n / nstrips - 1) & 1);
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          if (j < pairs) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int nt = 2 * j + h;
              const uint32_t top = saved_pair(p_s, g, nt, t, S);
              const uint32_t bottom = saved_pair(p_s, g + 8, nt, t, S);
              dp[nt][0] = bf16_lo(top) * (dp[nt][0] - dot0);
              dp[nt][1] = bf16_hi(top) * (dp[nt][1] - dot0);
              dp[nt][2] = bf16_lo(bottom) * (dp[nt][2] - dot1);
              dp[nt][3] = bf16_hi(bottom) * (dp[nt][3] - dot1);
            }
            uint32_t dsa[4];
            wide_round_a(dsa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              *reinterpret_cast<uint32_t*>(probs_at(ds_s, g, 2 * j + h) + 2 * t) = dsa[2 * h];
              *reinterpret_cast<uint32_t*>(probs_at(ds_s, g + 8, 2 * j + h) + 2 * t) =
                  dsa[2 * h + 1];
            }
          }
        }
        mbar_arrive(ds_full + n % nstrips);
        __syncwarp();
        // dQ_t = dS K * scale, dS's A fragments back from the slot; then the
        // dS half is free for the slot's next tile.
        const bf16* k_s = ring.acquire(op0 + kOpK);
        float dq[8][4];
        wide_zero<64>(dq);
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          if (j < pairs) {
            uint32_t dsa[4];
            ldmatrix_x4(dsa, probs_at(ds_s, lane & 15, 2 * j + (lane >> 4)));
            block_accumulate(dq, dsa, k_s, 16 * j, lane);
          }
        }
        __syncwarp();
        mbar_arrive(dq_done + n % nstrips);
        uint32_t rounded[8][2];
        round_tile(dq, scale, rounded);
        store_rounded_tile(rounded, dhead, row3, r0, S, lane);
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
      ring.acquire(op0 + kOpK);
      ring.release(op0 + kOpK, lane, load);
      ring.acquire(op0 + kOpQ);
      ring.release(op0 + kOpQ, lane, load);
    } else {  // the key side: keys k0 = 32 kw + 16 kt, kt = 0, 1
      const int kw = warp - kQ;
      ring.acquire(op0 + kOpV);  // the query side's operands
      ring.release(op0 + kOpV, lane, load);
      ring.acquire(op0 + kOpK);
      ring.release(op0 + kOpK, lane, load);
      const bf16* do_s = ring.acquire(op0 + kOpDo);
      const bf16* q_s = ring.acquire(op0 + kOpQ);
      float dk[2][8][4], dv[2][8][4];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        wide_zero<64>(dk[kt]);
        wide_zero<64>(dv[kt]);
      }
      // For each tile of 16 queries: P^T and dS^T of the warp's keys, as A
      // fragments by ldmatrix.trans of the slot's rows (this lane addresses
      // query row fq), dV_t += P^T dO, dK_t += dS^T Q.  Queries >= S read P
      // and dS as 0; keys >= S are rows of dK and dV never stored.
      const int fq = (lane & 7) + ((lane >> 4) << 3);
      for (int tile = 0; tile < pairs; ++tile) {
        const int n = i * pairs + tile;
        const bf16* p_s = strips.acquire(n);
        mbar_wait(ds_full + n % nstrips, (n / nstrips) & 1);
        const bf16* ds_s = p_s + kProbsTileElems;
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          const int k0 = 32 * kw + 16 * kt;
          if (k0 < s_pad) {
            const int c = (k0 >> 3) + ((lane >> 3) & 1);
            uint32_t a[4];
            ldmatrix_x4_trans(a, probs_at(p_s, fq, c));
            block_accumulate(dv[kt], a, do_s, 16 * tile, lane);
            ldmatrix_x4_trans(a, probs_at(ds_s, fq, c));
            block_accumulate(dk[kt], a, q_s, 16 * tile, lane);
          }
        }
        strips.release(n, lane, load_strip);
      }
      ring.release(op0 + kOpDo, lane, load);
      ring.release(op0 + kOpQ, lane, load);
      // dK_t, dV_t rounded once and stored, tile by tile, with their column
      // sums (kDb).
      float2 dk_sums[2] = {}, dv_sums[2] = {};
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const int k0 = 32 * kw + 16 * kt;
        if (k0 < s_pad) {
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
        const int turn = i * kBlockWideKeyWarps + kw;
        db_wait_turn(k_turn, turn);
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          const int tile = 2 * kw + kt;
          if (tile < pairs) {
            db_add(db_acc + 64, tile == 0, tile == pairs - 1, dk_sums[kt], db_out + C, lane);
            db_add(db_acc + 128, tile == 0, tile == pairs - 1, dv_sums[kt], db_out + 2 * C, lane);
          }
        }
        db_pass_turn(k_turn, turn, lane);
      }
    }
  }
}

// ---- launches -----------------------------------------------------------------

// The 3-d map (S16, S, B*H) over probs (B, H, S, S16) bf16 whose box is 16
// rows of 64 columns under the 128-byte swizzle (a probs tile's box).
inline cudaError_t probs_tensor_map(CUtensorMap* map, const bf16* probs, int seq, int items) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t s_pad = static_cast<cuuint64_t>((seq + 15) & ~15);
  const cuuint64_t dims[3] = {s_pad, static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(items)};
  const cuuint64_t strides[2] = {s_pad * sizeof(bf16), s_pad * seq * sizeof(bf16)};
  const cuuint32_t box[3] = {64, 16, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(probs), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch 3 of kernels 1 and 3 past the register tiles: qkv (B*S, 3C) -> out
// (B*S, C), heads of 64, 1 <= S <= 256; probs (B, H, S, S16) with kSaveProbs.
template <bool kSaveProbs, int kHalf>
cudaError_t launch_block_wide_fwd_at(const bf16* qkv, bf16* out, bf16* probs, int batch, int seq,
                                     int width, int heads, float scale, cudaStream_t st) {
  const int s_pad = (seq + 15) & ~15;
  const int tile = s_pad * 64 * static_cast<int>(sizeof(bf16));
  const int fixed = (kSaveProbs ? kBlockWideFwdStageBytes : 0) + kBlockWideFwdXBytes;
  const int fit = (kWideSmemLimit - kWideSlotWords - fixed) / tile;
  const int slots = fit < kWideMaxSlots ? fit : kWideMaxSlots;
  const int smem = fixed + slots * tile + kWideSlotWords;
  auto kernel = block_wide_fwd_kernel<kSaveProbs, kHalf>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(batch * heads, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[2];
  err = wide_tensor_maps<64>(maps, qkv, 3, 3 * width, batch, seq, heads);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBlockWideFwdWarps * 32, smem, st>>>(maps[0], out, probs, seq, width, heads,
                                                      batch * heads, slots, scale);
  return cudaGetLastError();
}

template <bool kSaveProbs>
cudaError_t launch_block_wide_fwd(const bf16* qkv, bf16* out, bf16* probs, int batch, int seq,
                                  int width, int heads, float scale, cudaStream_t st) {
  if (width != heads * 64 || seq < 1 || seq > kWideMaxSeq) return cudaErrorInvalidValue;
  return (seq + 15) / 16 <= kBlockWidePairsShort
             ? launch_block_wide_fwd_at<kSaveProbs, kBlockWidePairsShort / 2>(
                   qkv, out, probs, batch, seq, width, heads, scale, st)
             : launch_block_wide_fwd_at<kSaveProbs, kWideMaxPairs / 2>(
                   qkv, out, probs, batch, seq, width, heads, scale, st);
}

// Kernels 4 (kDb) and 7 past the register tiles: qkv (B*S, 3C), probs
// (B, H, S, S16), dout (B*S, C) -> dqkv (B*S, 3C) [and db_partial (B, 3C)],
// heads of 64, 1 <= S <= 256.
template <bool kDb, int kPairs>
cudaError_t launch_block_wide_bwd_at(const bf16* qkv, const bf16* probs, const bf16* dout,
                                     bf16* dqkv, float* db_partial, int batch, int seq,
                                     int width, int heads, float scale, cudaStream_t st) {
  const int s_pad = (seq + 15) & ~15;
  const int tile = s_pad * 64 * static_cast<int>(sizeof(bf16));
  const int room = kWideSmemLimit - kBlockWideBwdFixedBytes;
  const int fit_strips = (room - 4 * tile) / kBlockWideStripSlotBytes;
  const int nstrips = fit_strips < kBlockWideMaxStrips ? fit_strips : kBlockWideMaxStrips;
  const int strips = nstrips * kBlockWideStripSlotBytes;
  const int fit = (room - strips) / tile;
  const int slots = fit < kWideMaxSlots ? fit : kWideMaxSlots;
  const int smem = kBlockWideBwdFixedBytes + strips + slots * tile;
  auto kernel = block_wide_bwd_kernel<kDb, kPairs>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(batch * heads, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap qkv_maps[2], do_maps[2], probs_map;
  err = wide_tensor_maps<64>(qkv_maps, qkv, 3, 3 * width, batch, seq, heads);
  if (err != cudaSuccess) return err;
  err = wide_tensor_maps<64>(do_maps, dout, 1, width, batch, seq, heads);
  if (err != cudaSuccess) return err;
  err = probs_tensor_map(&probs_map, probs, seq, batch * heads);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBlockWideBwdWarps * 32, smem, st>>>(qkv_maps[0], do_maps[0], probs_map, dqkv,
                                                      db_partial, seq, width, heads,
                                                      batch * heads, slots, nstrips,
                                                      scale);
  return cudaGetLastError();
}

template <bool kDb>
cudaError_t launch_block_wide_bwd(const bf16* qkv, const bf16* probs, const bf16* dout,
                                  bf16* dqkv, float* db_partial, int batch, int seq, int width,
                                  int heads, float scale, cudaStream_t st) {
  if (width != heads * 64 || seq < 1 || seq > kWideMaxSeq) return cudaErrorInvalidValue;
  return (seq + 15) / 16 <= kBlockWidePairsShort
             ? launch_block_wide_bwd_at<kDb, kBlockWidePairsShort>(
                   qkv, probs, dout, dqkv, db_partial, batch, seq, width, heads, scale, st)
             : launch_block_wide_bwd_at<kDb, kWideMaxPairs>(qkv, probs, dout, dqkv, db_partial,
                                                           batch, seq, width, heads, scale, st);
}

}  // namespace
}  // namespace demo2
