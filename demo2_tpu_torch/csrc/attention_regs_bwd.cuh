// The register-resident attention backward: the second design of the
// recomputing attention backward.  Two kernels are instantiated from it, one
// per rounding mode:
//   Probs::kRecomputeF32  flash_attention.cu, kernel 10: replaces the Pallas
//       kernel demo2_tpu/ops/flash_attention.py::_bwd_kernel.  f32 throughout:
//       P and dS enter their products as a bf16 hi / lo split (two tensor-core
//       products into one f32 accumulator);
//   Probs::kRecompute     packed_attention.cu, kernel 6: replaces
//       demo2_tpu/ops/packed_attention.py::_bwd_kernel.  P is normalised in
//       f32; dV takes bf16(P), dS is computed from the f32 P and rounded to
//       bf16 once for the dQ and dK products.
// Probs::kSaved reads saved probabilities and stays on the first design
// (attention_bwd.cuh: kernels 4, 7 and 8).  Per (sample, head), from bf16 q,
// k, v and dO, with the probabilities recomputed from q and k,
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - rowsum(dP * P))  (from dP and
//   P, not through dO . O);  dQ = dS K * scale;  dK = dS^T Q * scale,
// the outputs rounded to bf16 once.
//
// What bounds the work on an H100: at 192 samples x 129 rows x 12 heads of 64
// the kernel must move 266 MB (0.080 ms at 3.35 TB/s) and counts 24.5 GFLOP.
// The first design (attention_bwd.cuh) took 15-17x that: one block per SM
// walked nine query tiles with six block barriers each, kept the dK / dV
// accumulators in shared memory (72 tiles loaded and stored per query tile)
// and passed S, P, dP and dS through shared memory.
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
// The grid is persistent (one 384-thread block an SM) and the tasks of a
// block's items, each item's query-owner tasks and then its key-owner tasks,
// form one stream that the twelve warps take in turn.  No block barrier exists
// after the start: a task waits on the item's `full` mbarrier (the TMA's
// completion), a key-owner task also on its `ready` one (nine arrivals, the
// query-owner tasks' statistics), and arrives on `empty`; the warp that took an
// item's first task asks for the next item once the one before is consumed.
// It recomputes QK^T and dO V^T (ten 144 x 144 x 64 products with the split
// where the first design ran eight: ~61 GFLOP executed, 0.06 ms at the tensor
// cores' peak; seven without the split, ~43 GFLOP) and buys: no load / store
// of 72 accumulator tiles on each of nine query tiles, no block barrier in
// place of 54 an item, every warp busy,
// tensor-core, ALU and special-function work of different tasks overlapping,
// and a fixed summation order: reruns are bit-identical.  Row statistics from
// the forward are not taken: the VJP's residuals are q, k and v only.
// Both kinds of task compute P from the same raw score, maximum and 1 / sum by
// the same expression (softmax_rows, attention_regs_fwd.cuh) and dS from the
// same dP and delta, so dQ and dK are products of one dS, rounded or split
// alike.
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
// Resources (nvcc 12.9, -Xptxas -v, sm_90a), both 150,968 bytes of dynamic
// shared memory, one block of twelve warps on an SM: kRecomputeF32 and
// kRecompute alike use 168 registers (the cap of three warps a sub-core) with
// a 56-byte stack frame (76 bytes of spill stores, 244 of spill loads).

#pragma once

#include "attention_bwd.cuh"
#include "attention_regs_fwd.cuh"

namespace demo2 {
namespace {

// kRegsBwdRing x [Q | K | V | dO], m / rinv / delta per ring slot, three
// mbarriers per slot and the index of the last item loaded into it
// (wait_started, attention_regs_fwd.cuh).
constexpr int kRegsBwdRing = 2;
constexpr int kRegsBwdWarps = 12;  // three on each sub-core (the forward has four)
constexpr int kRegsBwdThreads = kRegsBwdWarps * 32;
constexpr int kRegsBwdBf16Elems = kRegsBwdRing * 4 * kRegsTile;
constexpr int kRegsBwdSmemBytes = kRegsBwdBf16Elems * static_cast<int>(sizeof(bf16)) +
                                  kRegsBwdRing * 3 * kMaxSeq * static_cast<int>(sizeof(float)) +
                                  3 * kRegsBwdRing * 8 + kRegsBwdRing * 4;
static_assert(kRegsBwdSmemBytes <= 232448, "the ring of Q, K, V, dO must fit one SM");
static_assert((kRegsBwdBf16Elems * sizeof(bf16)) % 16 == 0 &&
                  (kRegsBwdRing * 3 * kMaxSeq * sizeof(float)) % 8 == 0,
              "the statistics are read as float2, the barriers are 8-byte words");

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

// Persistent, and a stream of tasks inside the block: an item is 2 x pairs
// tasks, its query-owner tiles and then its key-owner tiles; task u is task
// u % (2 pairs) of the block's item u / (2 pairs); warp w takes tasks w,
// w + 12, ...  A key-owner task waits for the item's `pairs` query-owner
// tasks, all earlier in the stream, so no wait can form a cycle.
template <Probs kMode>
__global__ void __launch_bounds__(kRegsBwdThreads, 1)
attention_regs_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map, bf16* __restrict__ dq,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, HeadLayout outl, int S,
                          int heads, int items, float scale) {
  static_assert(kMode != Probs::kSaved, "saved probabilities stay on attention_bwd.cuh");
  constexpr bool kSplit = kMode == Probs::kRecomputeF32;
  extern __shared__ __align__(1024) unsigned char regs_bwd_smem[];
  bf16* smem = reinterpret_cast<bf16*>(regs_bwd_smem);
  float* stats = reinterpret_cast<float*>(smem + kRegsBwdRing * 4 * kRegsTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kRegsBwdRing * 3 * kMaxSeq);
  uint64_t* empty = full + kRegsBwdRing;
  uint64_t* ready = empty + kRegsBwdRing;  // the item's statistics are complete
  volatile int* started = reinterpret_cast<volatile int*>(ready + kRegsBwdRing);

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int i) {  // one lane: the block's i-th item into slot i % kRegsBwdRing
    const int item = blockIdx.x + i * gridDim.x;
    const int slot = i % kRegsBwdRing;
    bf16* dst = smem + slot * 4 * kRegsTile;
    mbar_arrive_expect(full + slot, static_cast<uint32_t>(4 * s_pad * kRegsRowBytes));
    tma_load_head(dst, &q_map, item % heads, item / heads, full + slot);
    tma_load_head(dst + kRegsTile, &k_map, item % heads, item / heads, full + slot);
    tma_load_head(dst + 2 * kRegsTile, &v_map, item % heads, item / heads, full + slot);
    tma_load_head(dst + 3 * kRegsTile, &do_map, item % heads, item / heads, full + slot);
    started[slot] = i;
  };
  if (warp == 0 && lane == 0 && mine > 0) load(0);

  for (int u = warp; u < mine * 2 * pairs; u += kRegsBwdWarps) {
    const int i = u / (2 * pairs);
    const int task = u - i * 2 * pairs;
    const bool key_owner = task >= pairs;
    const int row0 = (key_owner ? task - pairs : task) * 16;
    const int b = i % kRegsBwdRing;
    const uint32_t parity = (i / kRegsBwdRing) & 1;
    const int item = blockIdx.x + i * gridDim.x;
    const bf16* q_s = smem + b * 4 * kRegsTile;
    const bf16* k_s = q_s + kRegsTile;
    const bf16* v_s = k_s + kRegsTile;
    const bf16* do_s = v_s + kRegsTile;
    float* m_s = stats + b * 3 * kMaxSeq;
    float* rinv_s = m_s + kMaxSeq;
    float* delta_s = rinv_s + kMaxSeq;
    const size_t dst = outl.at(item / heads, item % heads);
    wait_started(started + b, i);
    mbar_wait(full + b, parity);

    if (!key_owner) {  // query rows row0 .. row0 + 15
      float p[kRegsCols8][4];
      product_rows(p, q_s, row0, k_s, pairs, lane);
      float m0, m1, rinv0, rinv1;
      softmax_rows<true>(p, pairs, S, c, lane, m0, m1, rinv0, rinv1);
      float ds[kRegsCols8][4];
      product_rows(ds, do_s, row0, v_s, pairs, lane);
      float delta0 = 0.f, delta1 = 0.f;
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
      float acc[kRegsDim8][4];
#pragma unroll
      for (int nt = 0; nt < kRegsDim8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      product_regs<kSplit>(acc, ds, k_s, pairs, lane);
      store_tile_direct(acc, scale, dq + dst, outl.row, row0, S, lane);
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
    } else {  // keys row0 .. row0 + 15: rows are keys, columns queries
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
      float acc[kRegsDim8][4];
#pragma unroll
      for (int nt = 0; nt < kRegsDim8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      product_regs<kSplit>(acc, pt, do_s, pairs, lane);
      store_tile_direct(acc, 1.f, dv + dst, outl.row, row0, S, lane);

      float dst_t[kRegsCols8][4];
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
#pragma unroll
      for (int nt = 0; nt < kRegsDim8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      product_regs<kSplit>(acc, dst_t, q_s, pairs, lane);
      store_tile_direct(acc, scale, dk + dst, outl.row, row0, S, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + b);
    }
  }
}

template <Probs kMode>
cudaError_t launch_attention_regs_bwd(const bf16* q, const bf16* k, const bf16* v, HeadLayout in,
                                      const bf16* dout, HeadLayout dol, bf16* dq, bf16* dk,
                                      bf16* dv, HeadLayout outl, int batch, int seq, int heads,
                                      float scale, cudaStream_t st) {
  auto kernel = attention_regs_bwd_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kRegsBwdSmemBytes);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = regs_grid(batch * heads, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  const bf16* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    err = head_tensor_map(&maps[i], bases[i], i < 3 ? in : dol, batch, seq, heads);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kRegsBwdThreads, kRegsBwdSmemBytes, st>>>(maps[0], maps[1], maps[2], maps[3], dq, dk,
                                                         dv, outl, seq, heads, batch * heads,
                                                         scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2
