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
// ms) for 52.5 GFLOP.  Bytes bound both.  Times: PERF.md §6.
//
// The design: the wide pair's (packed_attention_wide.cu, on
// attention_wide.cuh): a persistent block walks its (sample, head) items
// through one stream of 16-row tasks, each item's Q, K, V (and dO) one TMA
// copy each into a ring of S16 x 64 operand tiles, a slot refilled as soon as
// every task of its item has released it.
//   * Forward (sixteen warps): a task is 16 query rows.  A 16 x S16 f32 score
//     row would not fit beside the rest, and the normalised p needs the whole
//     row's sum before its first element, so QK^T runs three times: the row
//     maximum, then the sum of the exps, then p, its bf16 store (kernel 3)
//     and PV with the same bf16 registers.  Simple; the tensor cores are not
//     what holds the wide forward back (packed_attention_wide.cu).
//   * Backward: an item is S16 / 16 query-owner tasks, then as many
//     key-owner tasks.  No task holds a whole P and none goes through shared
//     memory: a query-owner task (rows r0 .. r0 + 15) reads its 16 rows of P
//     from device memory straight into the layout of dP's accumulator (bf16
//     pairs, 4-byte loads), computes dP = dO_t V^T 16 keys at a time for
//     delta = rowsum(dP P), leaves delta in shared memory for the item's
//     key-owner tasks, then dP again, dS, dQ_t += dS K.  A key-owner task
//     (keys k0 .. k0 + 15) reads its 16 columns of P, 16 queries at a time,
//     as A fragments of P^T (2-byte loads: a fragment pairs two rows of P);
//     dV_t += P^T dO, dP^T = V_t dO^T, then, with delta, dS^T and
//     dK_t += dS^T Q.  Twelve warps (168 registers a thread; the
//     query-owner's 64 registers of P spill a little: 208 bytes).  Measured
//     on the way (kernel 4 at qkv (192, 211, 2304), NVIDIA H100 80GB HBM3,
//     700 W, one call each): this form 0.926 ms; eight warps (255
//     registers) with each key-owner task loading its whole strip before
//     its first product 1.124; twelve warps loading the strip one tile
//     ahead of its products 1.070 (kernel 7 0.925 against 0.916).  Each task still acquires and releases all four
//     operands of its item, the ones it does not read at once, so that the
//     ring counts every release of a slot.  db: the regs backward's
//     (tile_column_sums, the turn in stream order, attention_regs_bwd.cuh).
//     Every wait is for an earlier task of the stream, so none can form a
//     cycle.

#pragma once

#include "attention_regs_bwd.cuh"
#include "attention_wide.cuh"

namespace demo2 {
namespace {

constexpr int kBlockWideBwdWarps = 12;
// The db accumulator (dq | dk | dv, 64 floats each) and the turn of the stream.
constexpr int kBlockWideDbWords = 3 * 64 * 4 + 16;

// ---- the forward --------------------------------------------------------------

// Persistent; task u is 16-row tile u % pairs of the block's item u / pairs,
// warp w takes tasks w, w + 16, ...; operand 3 i + {0, 1, 2} is Q, K, V of
// the block's item i.  `probs` (B, H, S, S16): kSaveProbs only.
template <bool kSaveProbs>
__global__ void __launch_bounds__(kWideFwdWarps * 32, 1)
block_wide_fwd_kernel(const __grid_constant__ CUtensorMap map, bf16* __restrict__ out,
                      bf16* __restrict__ probs, int S, int C, int heads, int items, int slots,
                      float scale) {
  extern __shared__ __align__(1024) unsigned char block_wide_fwd_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s_pad = (S + 15) & ~15;
  const int pairs = s_pad / 16;
  const int mine = block_items(items);
  WideRing ring{nullptr, nullptr, nullptr, nullptr, nullptr, slots, s_pad * 64, pairs, 3 * mine};
  ring.init(block_wide_fwd_smem);
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

  for (int u = warp; u < mine * pairs; u += kWideFwdWarps) {
    const int i = u / pairs;
    const int r0 = (u - i * pairs) * 16;
    const int item = blockIdx.x + i * gridDim.x;
    uint32_t qa[4][4];
    wide_rows<64>(qa, ring.acquire(3 * i), s_pad, r0, lane);
    ring.release(3 * i, lane, load);
    const bf16* k_s = ring.acquire(3 * i + 1);

    // The first pass: m = the max of s * scale over keys < S.
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int n0 = 0; n0 < s_pad; n0 += 16) {
      float s[2][4];
      wide_scores<64>(s, qa, k_s, s_pad, n0, lane);
      const bool whole = n0 + 16 <= S;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (whole || n0 + 8 * j + 2 * t + (e & 1) < S) {
            const float v = __fmul_rn(s[j][e], scale);
            if (e < 2) m0 = fmaxf(m0, v); else m1 = fmaxf(m1, v);
          }
        }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    // The second: the sum of e = expf(s * scale - m) over keys < S.
    float sum0 = 0.f, sum1 = 0.f;
    for (int n0 = 0; n0 < s_pad; n0 += 16) {
      float s[2][4];
      wide_scores<64>(s, qa, k_s, s_pad, n0, lane);
      const bool whole = n0 + 16 <= S;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (whole || n0 + 8 * j + 2 * t + (e & 1) < S) {
            const float x = expf(__fmul_rn(s[j][e], scale) - (e < 2 ? m0 : m1));
            if (e < 2) sum0 += x; else sum1 += x;
          }
        }
    }
    const float d0 = quad_sum(sum0) + 1e-30f, d1 = quad_sum(sum1) + 1e-30f;
    const float rd0 = 1.f / d0, rd1 = 1.f / d1;

    // The third: p = e / (sum + 1e-30) (0 at keys >= S), rounded to bf16
    // once for PV and, in kernel 3, for the probs rows r0 + g, r0 + g + 8.
    const bf16* v_s = ring.acquire(3 * i + 2);
    float o[8][4];
    wide_zero<64>(o);
    bf16* p_top = kSaveProbs ? probs + (static_cast<size_t>(item) * S + r0 + g) * s_pad + 2 * t
                             : nullptr;
    const bool top = r0 + g < S, bottom = r0 + g + 8 < S;
    for (int n0 = 0; n0 < s_pad; n0 += 16) {
      float s[2][4];
      wide_scores<64>(s, qa, k_s, s_pad, n0, lane);
      const bool whole = n0 + 16 <= S;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          s[j][e] = whole || n0 + 8 * j + 2 * t + (e & 1) < S
                        ? wide_quotient(expf(__fmul_rn(s[j][e], scale) - (lo ? m0 : m1)),
                                        lo ? d0 : d1, lo ? rd0 : rd1)
                        : 0.f;
        }
      uint32_t pa[4];
      wide_round_a(pa, s[0], s[1]);
      if constexpr (kSaveProbs) {
        if (top) {
          *reinterpret_cast<uint32_t*>(p_top + n0) = pa[0];
          *reinterpret_cast<uint32_t*>(p_top + n0 + 8) = pa[2];
        }
        if (bottom) {
          *reinterpret_cast<uint32_t*>(p_top + 8 * s_pad + n0) = pa[1];
          *reinterpret_cast<uint32_t*>(p_top + 8 * s_pad + n0 + 8) = pa[3];
        }
      }
      wide_accumulate<64>(o, pa, v_s, s_pad, n0, lane);
    }
    ring.release(3 * i + 1, lane, load);
    ring.release(3 * i + 2, lane, load);
    wide_store<64>(o, 1.f, out + static_cast<size_t>(item / heads) * S * C + (item % heads) * 64,
                   C, r0, S, lane);
  }
}

// ---- the backward -------------------------------------------------------------

// Two saved bf16 p of one row, cols col and col + 1, as one register (col in
// the low half); 0 where the row is not < S, or a column is not.
__device__ __forceinline__ uint32_t saved_pair(const bf16* p, bool row_ok, int col, int S) {
  if (!row_ok || col >= S) return 0u;
  const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
  return col + 1 < S ? w : (w & 0xffffu);
}

// One saved bf16 p as the low 16 bits of a register; 0 where the row is not < S.
__device__ __forceinline__ uint32_t saved_one(const bf16* p, bool row_ok) {
  return row_ok ? static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))) : 0u;
}

// Persistent; an item is 2 x pairs tasks, its query-owner tiles and then its
// key-owner tiles; task u is task u % (2 pairs) of the block's item
// u / (2 pairs), warp w takes tasks w, w + 12, ...; operand 4 i + {0, 1, 2, 3}
// is K, Q, V, dO of the block's item i.  `db_partial` (B, 3C): kDb only.
template <bool kDb>
__global__ void __launch_bounds__(kBlockWideBwdWarps * 32, 1)
block_wide_bwd_kernel(const __grid_constant__ CUtensorMap qkv_map,
                      const __grid_constant__ CUtensorMap do_map, const bf16* __restrict__ probs,
                      bf16* __restrict__ dqkv, float* __restrict__ db_partial, int S, int C,
                      int heads, int items, int slots, int nstats, float scale) {
  extern __shared__ __align__(1024) unsigned char block_wide_bwd_smem[];
  constexpr int kOpK = 0, kOpQ = 1, kOpV = 2, kOpDo = 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s_pad = (S + 15) & ~15;
  const int pairs = s_pad / 16;
  const int mine = block_items(items);
  WideRing ring{nullptr, nullptr, nullptr, nullptr, nullptr, slots, s_pad * 64, 2 * pairs,
                4 * mine};
  ring.init(block_wide_bwd_smem);
  // delta of each query row, per statistics slot; per statistics slot an
  // mbarrier and a count of the query-owner tasks that filled it and of the
  // key-owner tasks done with it; then the db accumulator and its turn.
  float* stats = reinterpret_cast<float*>(ring.released + kWideMaxSlots);
  uint64_t* ready = reinterpret_cast<uint64_t*>(stats + nstats * s_pad);
  uint64_t* done = ready + kWideMaxStats;
  volatile int* filled = reinterpret_cast<volatile int*>(done + kWideMaxStats);
  volatile int* finished = filled + kWideMaxStats;
  float* db_acc = reinterpret_cast<float*>(const_cast<int*>(finished + kWideMaxStats));
  volatile int* db_turn = reinterpret_cast<volatile int*>(db_acc + 3 * 64);
  auto load = [&](int n, bf16* dst, uint64_t* bar) {
    const int item = blockIdx.x + (n / 4) * gridDim.x;
    const int op = n % 4;
    if (op == kOpDo) {
      wide_load<64>(dst, s_pad, &do_map, &do_map, item % heads, 0, item / heads, bar);
    } else {
      wide_load<64>(dst, s_pad, &qkv_map, &qkv_map, item % heads,
                    op == kOpK ? 1 : op == kOpQ ? 0 : 2, item / heads, bar);
    }
  };
  if (threadIdx.x == 0) {
    ring.reset();
    for (int b = 0; b < nstats; ++b) {
      mbar_init(ready + b, pairs);
      mbar_init(done + b, pairs);
      filled[b] = 0;
      finished[b] = 0;
    }
    if (kDb) *db_turn = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int n = 0; n < slots && n < ring.ops; ++n) {
      load(n, ring.tiles + n * ring.slot_elems, ring.full + n);
      ring.started[n] = n;
    }
  }

  const int row3 = 3 * C;
  for (int u = warp; u < mine * 2 * pairs; u += kBlockWideBwdWarps) {
    const int i = u / (2 * pairs);
    const int task = u - i * 2 * pairs;
    const bool key_owner = task >= pairs;
    const int tile = key_owner ? task - pairs : task;
    const int r0 = tile * 16;
    const int item = blockIdx.x + i * gridDim.x;
    const int stat = i % nstats;
    const int round = i / nstats;  // earlier items that used this statistics slot
    float* delta_s = stats + stat * s_pad;
    bf16* dhead = dqkv + static_cast<size_t>(item / heads) * S * row3 + (item % heads) * 64;
    float* db_out = kDb ? db_partial + static_cast<size_t>(item / heads) * 3 * C +
                              (item % heads) * 64
                        : nullptr;
    const bf16* p_item = probs + static_cast<size_t>(item) * S * s_pad;  // its S rows of S16
    const int op0 = 4 * i;

    if (!key_owner) {  // query rows r0 .. r0 + 15
      const bf16* k_s = ring.acquire(op0 + kOpK);
      ring.acquire(op0 + kOpQ);  // the key-owner tasks' operand
      ring.release(op0 + kOpQ, lane, load);
      const bf16* v_s = ring.acquire(op0 + kOpV);
      uint32_t da[4][4];
      wide_rows<64>(da, ring.acquire(op0 + kOpDo), s_pad, r0, lane);
      ring.release(op0 + kOpDo, lane, load);
      // P rows r0 + g (pf[j][2 h]) and r0 + g + 8 (pf[j][2 h + 1]) at keys
      // 16 j + 8 h + 2 t, + 1: where dP's accumulator holds its pairs.
      uint32_t pf[kWideMaxPairs][4];
      const bool top = r0 + g < S, bottom = r0 + g + 8 < S;
      const bf16* prow = p_item + static_cast<size_t>(r0 + g) * s_pad + 2 * t;
#pragma unroll
      for (int j = 0; j < kWideMaxPairs; ++j) {
        if (j < pairs) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = 16 * j + 8 * h + 2 * t;
            pf[j][2 * h] = saved_pair(prow + 16 * j + 8 * h, top, col, S);
            pf[j][2 * h + 1] = saved_pair(prow + 8 * s_pad + 16 * j + 8 * h, bottom, col, S);
          }
        }
      }
      float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
      for (int j = 0; j < kWideMaxPairs; ++j) {
        if (j < pairs) {
          float dp[2][4];
          wide_scores<64>(dp, da, v_s, s_pad, 16 * j, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            dot0 += dp[h][0] * bf16_lo(pf[j][2 * h]) + dp[h][1] * bf16_hi(pf[j][2 * h]);
            dot1 += dp[h][2] * bf16_lo(pf[j][2 * h + 1]) + dp[h][3] * bf16_hi(pf[j][2 * h + 1]);
          }
        }
      }
      dot0 = quad_sum(dot0);
      dot1 = quad_sum(dot1);
      // delta of the item's rows, once the key-owner tasks of the item that
      // used this statistics slot before are done with it.
      if (round > 0) {
        wide_wait_count(finished + stat, round * pairs);
        mbar_wait(done + stat, (round - 1) & 1);
      }
      if (t == 0) {
        delta_s[r0 + g] = dot0;
        delta_s[r0 + g + 8] = dot1;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(ready + stat);
        atomicAdd(const_cast<int*>(filled + stat), 1);
      }

      // dP again, dS = P (dP - delta) rounded once, dQ_t += dS K.
      float dq[8][4];
      wide_zero<64>(dq);
#pragma unroll
      for (int j = 0; j < kWideMaxPairs; ++j) {
        if (j < pairs) {
          float ds[2][4];
          wide_scores<64>(ds, da, v_s, s_pad, 16 * j, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ds[h][0] = bf16_lo(pf[j][2 * h]) * (ds[h][0] - dot0);
            ds[h][1] = bf16_hi(pf[j][2 * h]) * (ds[h][1] - dot0);
            ds[h][2] = bf16_lo(pf[j][2 * h + 1]) * (ds[h][2] - dot1);
            ds[h][3] = bf16_hi(pf[j][2 * h + 1]) * (ds[h][3] - dot1);
          }
          uint32_t dsa[4];
          wide_round_a(dsa, ds[0], ds[1]);
          wide_accumulate<64>(dq, dsa, k_s, s_pad, 16 * j, lane);
        }
      }
      ring.release(op0 + kOpK, lane, load);
      ring.release(op0 + kOpV, lane, load);
      uint32_t rounded[8][2];
      round_tile(dq, scale, rounded);
      store_rounded_tile(rounded, dhead, row3, r0, S, lane);
      if constexpr (kDb) {
        const float2 sums = tile_column_sums(rounded, r0, S, lane);
        db_wait_turn(db_turn, u);
        db_add(db_acc, tile == 0, tile == pairs - 1, sums, db_out, lane);
        db_pass_turn(db_turn, u, lane);
      }
    } else {  // keys r0 .. r0 + 15: rows are keys, columns queries
      ring.acquire(op0 + kOpK);  // the query-owner tasks' operand
      ring.release(op0 + kOpK, lane, load);
      uint32_t va[4][4];
      wide_rows<64>(va, ring.acquire(op0 + kOpV), s_pad, r0, lane);
      ring.release(op0 + kOpV, lane, load);
      const bf16* q_s = ring.acquire(op0 + kOpQ);
      const bf16* do_s = ring.acquire(op0 + kOpDo);
      float dk[8][4], dv[8][4];
      wide_zero<64>(dk);
      wide_zero<64>(dv);
      // Queries i0 .. i0 + 15: P^T of keys r0 + g (pt[2 h]) and r0 + g + 8
      // (pt[2 h + 1]) at queries i0 + 8 h + 2 t, + 1 is the A fragment of
      // dV_t += P^T dO; dP^T = V_t dO^T; dS^T = P^T (dP^T - delta), rounded
      // once, for dK_t += dS^T Q.  Queries >= S read P as 0 (their delta,
      // dO and Q rows are 0 too); keys >= S are rows of dK and dV that are
      // never stored.
      wide_wait_count(filled + stat, (round + 1) * pairs);
      mbar_wait(ready + stat, round & 1);
      const bf16* pcol = p_item + r0 + g;
      for (int i0 = 0; i0 < s_pad; i0 += 16) {
        uint32_t pt[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = i0 + 8 * h + 2 * t;
          const bf16* a = pcol + static_cast<size_t>(q) * s_pad;
          pt[2 * h] = saved_one(a, q < S) | (saved_one(a + s_pad, q + 1 < S) << 16);
          pt[2 * h + 1] = saved_one(a + 8, q < S) | (saved_one(a + s_pad + 8, q + 1 < S) << 16);
        }
        wide_accumulate<64>(dv, pt, do_s, s_pad, i0, lane);
        float dpt[2][4];
        wide_scores<64>(dpt, va, do_s, s_pad, i0, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 d = *reinterpret_cast<const float2*>(delta_s + i0 + 8 * h + 2 * t);
          dpt[h][0] = bf16_lo(pt[2 * h]) * (dpt[h][0] - d.x);
          dpt[h][1] = bf16_hi(pt[2 * h]) * (dpt[h][1] - d.y);
          dpt[h][2] = bf16_lo(pt[2 * h + 1]) * (dpt[h][2] - d.x);
          dpt[h][3] = bf16_hi(pt[2 * h + 1]) * (dpt[h][3] - d.y);
        }
        uint32_t dsa[4];
        wide_round_a(dsa, dpt[0], dpt[1]);
        wide_accumulate<64>(dk, dsa, q_s, s_pad, i0, lane);
      }
      ring.release(op0 + kOpQ, lane, load);
      ring.release(op0 + kOpDo, lane, load);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(done + stat);
        atomicAdd(const_cast<int*>(finished + stat), 1);
      }
      uint32_t rounded_k[8][2], rounded_v[8][2];
      round_tile(dk, scale, rounded_k);
      store_rounded_tile(rounded_k, dhead + C, row3, r0, S, lane);
      round_tile(dv, 1.f, rounded_v);
      store_rounded_tile(rounded_v, dhead + 2 * C, row3, r0, S, lane);
      if constexpr (kDb) {
        const float2 dk_sums = tile_column_sums(rounded_k, r0, S, lane);
        const float2 dv_sums = tile_column_sums(rounded_v, r0, S, lane);
        db_wait_turn(db_turn, u);
        db_add(db_acc + 64, tile == 0, tile == pairs - 1, dk_sums, db_out + C, lane);
        db_add(db_acc + 128, tile == 0, tile == pairs - 1, dv_sums, db_out + 2 * C, lane);
        db_pass_turn(db_turn, u, lane);
      }
    }
  }
}

// ---- launches -----------------------------------------------------------------

// The backward's operand slots and delta slots (s_pad floats each).
inline void block_wide_bwd_slots(int s_pad, int* slots, int* nstats) {
  const int stat_bytes = s_pad * static_cast<int>(sizeof(float));
  const int tile = s_pad * 64 * static_cast<int>(sizeof(bf16));
  const int room = kWideSmemLimit - kWideSlotWords - kWideStatWords - kBlockWideDbWords;
  const int fit = (room - 2 * stat_bytes) / tile;
  *slots = fit < kWideMaxSlots ? fit : kWideMaxSlots;
  const int stats = (room - *slots * tile) / stat_bytes;
  *nstats = stats < kWideMaxStats ? stats : kWideMaxStats;
}
static_assert(kWideSmemLimit - kWideSlotWords - kWideStatWords - kBlockWideDbWords -
                      2 * kWideMaxSeq * 4 >= 4 * kWideMaxSeq * 64 * 2,
              "the backward's ring holds one item's K, Q, V and dO and two delta slots");

// Launch 3 of kernels 1 and 3 past the register tiles: qkv (B*S, 3C) -> out
// (B*S, C), heads of 64, 1 <= S <= 256; probs (B, H, S, S16) with kSaveProbs.
template <bool kSaveProbs>
cudaError_t launch_block_wide_fwd(const bf16* qkv, bf16* out, bf16* probs, int batch, int seq,
                                  int width, int heads, float scale, cudaStream_t st) {
  if (width != heads * 64 || seq < 1 || seq > kWideMaxSeq) return cudaErrorInvalidValue;
  const int s_pad = (seq + 15) & ~15;
  const int slots = wide_fwd_slots(s_pad, 64);
  const int smem = slots * s_pad * 64 * static_cast<int>(sizeof(bf16)) + kWideSlotWords;
  auto kernel = block_wide_fwd_kernel<kSaveProbs>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(batch * heads, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[2];
  err = wide_tensor_maps<64>(maps, qkv, 3, 3 * width, batch, seq, heads);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWideFwdWarps * 32, smem, st>>>(maps[0], out, probs, seq, width, heads,
                                                 batch * heads, slots, scale);
  return cudaGetLastError();
}

// Kernels 4 (kDb) and 7 past the register tiles: qkv (B*S, 3C), probs
// (B, H, S, S16), dout (B*S, C) -> dqkv (B*S, 3C) [and db_partial (B, 3C)],
// heads of 64, 1 <= S <= 256.
template <bool kDb>
cudaError_t launch_block_wide_bwd(const bf16* qkv, const bf16* probs, const bf16* dout,
                                  bf16* dqkv, float* db_partial, int batch, int seq, int width,
                                  int heads, float scale, cudaStream_t st) {
  if (width != heads * 64 || seq < 1 || seq > kWideMaxSeq) return cudaErrorInvalidValue;
  const int s_pad = (seq + 15) & ~15;
  int slots = 0, nstats = 0;
  block_wide_bwd_slots(s_pad, &slots, &nstats);
  const int smem = slots * s_pad * 64 * static_cast<int>(sizeof(bf16)) + kWideSlotWords +
                   nstats * s_pad * static_cast<int>(sizeof(float)) + kWideStatWords +
                   kBlockWideDbWords;
  auto kernel = block_wide_bwd_kernel<kDb>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(batch * heads, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap qkv_maps[2], do_maps[2];
  err = wide_tensor_maps<64>(qkv_maps, qkv, 3, 3 * width, batch, seq, heads);
  if (err != cudaSuccess) return err;
  err = wide_tensor_maps<64>(do_maps, dout, 1, width, batch, seq, heads);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBlockWideBwdWarps * 32, smem, st>>>(qkv_maps[0], do_maps[0], probs, dqkv,
                                                      db_partial, seq, width, heads,
                                                      batch * heads, slots, nstats, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2
