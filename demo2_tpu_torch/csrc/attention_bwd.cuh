// The first design of the attention backward from saved probabilities: the
// attention part of kernel 8 (attention_bwd_fused_dw.cu).  Kernels 4 and 7,
// like 6 and 10, run on attention_regs_bwd.cuh.
// Per (sample, head), from bf16 q, k, v, dO and the forward's saved bf16 P:
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - rowsum(dP * P))   (f32, from
//   dP and P, not through dO.O), rounded to bf16 once;  dQ = dS K * scale;
//   dK = dS^T Q * scale;  dq, dk, dv rounded to bf16.
// Where P comes from and where it is rounded is the Probs mode, listed at the
// enum below; this file carries Probs::kSaved alone.  The rounded dq, dk, dv
// never leave the SM: they stay in shared memory as bf16 tiles (rows >= S
// zero) for the products that follow in the same block (kernel 8's dt, dW_qkv
// and db_qkv).
//
// Layouts: q, k, v through HeadLayout `in`, dO through `dol`
// (attention_fwd.cuh); probs (B, H, S, S16) bf16, S16 = S rounded up to 16,
// zero columns >= S (demo2_tpu_torch/ops/packed_attention.py, the one
// definition of that layout).
//
// Design: the whole 256-thread block (8 warps) carries one (head, sample).  Q,
// K, V and dO of the head (<= 144 x 64 bf16 each) and f32 dK / dV accumulators
// live in shared memory (~197 KB with the dq tile, so one block per SM); the
// queries are walked in 16-row tiles.  dK and dV sum over every query row,
// so keeping the whole sequence in one block needs no second pass over the
// queries.  Per tile: the saved P rows -> dP (wmma) -> dS on CUDA cores, one
// warp per 2 rows -> dV += P^T dO and dK += dS^T Q (wmma, accumulators loaded
// from and stored to shared memory) and dQ = dS K (wmma) -> bf16 rows of dq.
//
// What bounds it on an H100: at the ViT-B shape (B = 192, S = 129, 12 heads
// of 64) the attention reads q, k, v and dO (152 MB; the saved probs another
// 86 MB): ~0.07 ms at the card's 3.35 TB/s.  Its 2 x 4 x 129 x 144 x 64 FLOP
// per (sample, head), ~22 GFLOP in all, run through simple wmma tiles with one
// block per SM; five block barriers a query tile and 72 accumulator tiles
// loaded and stored on each held kernel 4's first design, this tile with its
// outputs written out, at ten times that (1.01 ms): the shared-memory traffic
// of those tiles, not device memory, bounds this design.
// attention_regs_bwd.cuh keeps all of it in registers.

#pragma once

#include <mma.h>

#include "attention_fwd.cuh"
#include "gemm.cuh"

namespace demo2 {
namespace {

// Heads of kHeadDim, keys and queries up to kMaxSeq (attention_fwd.cuh).
constexpr int kBwdQTile = 16;              // query rows per step (one wmma tile)
constexpr int kBwdThreads = 256;           // 8 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kLdH = kHeadDim + 8;      // bf16 rows of Q, K, V, dO
constexpr int kLdAcc = kHeadDim + 4;    // f32 rows of dK, dV
constexpr int kLdPt = kMaxSeq + 8;      // bf16 rows of the P and dS tiles
constexpr int kLdF = kMaxSeq + 4;       // f32 rows of the dP tile and the dQ staging
constexpr int kHeadElems = kMaxSeq * kLdH;
constexpr int kAccElems = kMaxSeq * kLdAcc;
constexpr int kPTileElems = kBwdQTile * kLdPt;
constexpr int kFTileElems = kBwdQTile * kLdF;

// Where P comes from and where the backward rounds, and which header
// instantiates the mode:
//   kSaved (packed_attention.py::_bwd_saved(_db)_kernel; kernels 4 and 7 on
//       attention_regs_bwd.cuh, kernel 8 on this file): P is the forward's
//       saved bf16 p; dS uses that bf16 p and is rounded to bf16 before the
//       dQ / dK products;
//   kRecompute (packed_attention.py::_bwd_kernel; kernel 6,
//       attention_regs_bwd.cuh only): p is
//       recomputed from Q and K in f32 (exp(s - max) / (sum + 1e-30)); dV
//       takes bf16(p), dS takes the f32 p and is rounded to bf16 before the
//       dQ / dK products;
//   kRecomputeF32 (flash_attention.py::_bwd_kernel, kernel 10;
//       attention_regs_bwd.cuh only): f32 throughout.
enum class Probs { kSaved, kRecompute, kRecomputeF32 };

// Shared memory of one block: Q, K, V, dO; dK, dV; the P and dS tiles; the
// f32 tile; the bf16 dq of the head.
constexpr int kBwdDqOffset =
    4 * kHeadElems * 2 + 2 * kAccElems * 4 + 2 * kPTileElems * 2 + kFTileElems * 4;
constexpr int kBwdSmemBytes = kBwdDqOffset + kHeadElems * 2;
static_assert(kBwdSmemBytes <= 232448, "the block must fit one SM's shared memory");
static_assert((kHeadElems * 2) % 128 == 0 && (kAccElems * 4) % 128 == 0 &&
                  (kPTileElems * 2) % 128 == 0 && (kFTileElems * 4) % 128 == 0,
              "wmma needs 32-byte aligned tiles");

// The backward of one (sample b, head h) by the whole block.  Nothing is
// written to device memory: on return (after a block barrier) the bf16 dq, dk
// and dv of the head, rows < S16 and rows >= S zero, lie in shared memory at
// bwd_dq_tile(), the Q region and the K region, each [row * kLdH + d]; every
// other region is free.
__device__ __forceinline__ void attention_bwd_head(
    unsigned char* bwd_smem, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, HeadLayout in, const bf16* __restrict__ dout, HeadLayout dol,
    const bf16* __restrict__ probs, int S, float scale, int h, int b, int heads) {
  using namespace nvcuda;
  bf16* q_s = reinterpret_cast<bf16*>(bwd_smem);
  bf16* k_s = q_s + kHeadElems;
  bf16* v_s = k_s + kHeadElems;
  bf16* do_s = v_s + kHeadElems;
  float* dk_s = reinterpret_cast<float*>(do_s + kHeadElems);
  float* dv_s = dk_s + kAccElems;
  bf16* p_s = reinterpret_cast<bf16*>(dv_s + kAccElems);
  bf16* ds_s = p_s + kPTileElems;
  float* f_s = reinterpret_cast<float*>(ds_s + kPTileElems);
  bf16* dq_s = reinterpret_cast<bf16*>(bwd_smem + kBwdDqOffset);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s_pad = (S + 15) & ~15;
  const size_t src = in.at(b, h);
  const size_t do_src = dol.at(b, h);
  const bf16* p_src = probs + (static_cast<size_t>(b) * heads + h) * S * s_pad;

  // Q, K, V, dO of the head, rows >= S zero; dK = dV = 0.
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < s_pad * 8; i += kBwdThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    const bool ok = r < S;
    const size_t row = src + static_cast<size_t>(r) * in.row + c;
    *reinterpret_cast<uint4*>(&q_s[r * kLdH + c]) =
        ok ? *reinterpret_cast<const uint4*>(q + row) : zero;
    *reinterpret_cast<uint4*>(&k_s[r * kLdH + c]) =
        ok ? *reinterpret_cast<const uint4*>(k + row) : zero;
    *reinterpret_cast<uint4*>(&v_s[r * kLdH + c]) =
        ok ? *reinterpret_cast<const uint4*>(v + row) : zero;
    *reinterpret_cast<uint4*>(&do_s[r * kLdH + c]) =
        ok ? *reinterpret_cast<const uint4*>(dout + do_src + static_cast<size_t>(r) * dol.row + c)
           : zero;
  }
  for (int i = tid; i < s_pad * kLdAcc; i += kBwdThreads) {
    dk_s[i] = 0.f;
    dv_s[i] = 0.f;
  }
  __syncthreads();

  const int vecs = s_pad / 8;
  const int key_tiles = s_pad / 16;
  const int rows_per_warp = kBwdQTile / kBwdWarps;
  for (int q0 = 0; q0 < S; q0 += kBwdQTile) {
    // 1. The saved P tile: 16 query rows x S16 keys, rows >= S zero.
    for (int i = tid; i < kBwdQTile * vecs; i += kBwdThreads) {
      const int r = i / vecs;
      const int c = (i - r * vecs) * 8;
      *reinterpret_cast<uint4*>(&p_s[r * kLdPt + c]) =
          q0 + r < S
              ? *reinterpret_cast<const uint4*>(p_src + static_cast<size_t>(q0 + r) * s_pad + c)
              : zero;
    }
    // 2. dP = dO_tile V^T -> f_s: the warps split the key tiles.
    for (int nt = warp; nt < key_tiles; nt += kBwdWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHeadDim; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, do_s + q0 * kLdH + kk, kLdH);
        wmma::load_matrix_sync(fb, v_s + nt * 16 * kLdH + kk, kLdH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(f_s + nt * 16, acc, kLdF, wmma::mem_row_major);
    }
    __syncthreads();

    // 3. dS = P * (dP - rowsum(dP * P)) in f32 from the saved bf16 p,
    //    rounded to bf16: warp w owns rows 2w and 2w + 1.
    //    Columns >= S have P = 0, so dS = 0 there.
#pragma unroll
    for (int rr = 0; rr < rows_per_warp; ++rr) {
      const int r = warp * rows_per_warp + rr;
      const float* dp = f_s + r * kLdF;
      auto p_at = [&](int j) { return __bfloat162float(p_s[r * kLdPt + j]); };
      float sum = 0.f;
      for (int j = lane; j < s_pad; j += 32) sum += dp[j] * p_at(j);
      sum = warp_sum(sum);
      for (int j = lane; j < s_pad; j += 32) {
        ds_s[r * kLdPt + j] = __float2bfloat16_rn(p_at(j) * (dp[j] - sum));
      }
    }
    __syncthreads();

    // 4. dV += P^T dO_tile and dK += dS^T Q_tile: S16/16 x 4 output tiles
    //    each, the accumulators kept in shared memory.  A^T is read
    //    col-major straight from the row-major P / dS tile.
    for (int i = warp; i < 2 * key_tiles * 4; i += kBwdWarps) {
      const bool is_k = i >= key_tiles * 4;
      const int j = is_k ? i - key_tiles * 4 : i;
      const int mt = j >> 2;
      const int nt = j & 3;
      float* acc_p = (is_k ? dk_s : dv_s) + mt * 16 * kLdAcc + nt * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(acc, acc_p, kLdAcc, wmma::mem_row_major);
      wmma::load_matrix_sync(fb, (is_k ? q_s : do_s) + q0 * kLdH + nt * 16, kLdH);
      wmma::load_matrix_sync(fa, (is_k ? ds_s : p_s) + mt * 16, kLdPt);
      wmma::mma_sync(acc, fa, fb, acc);
      wmma::store_matrix_sync(acc_p, acc, kLdAcc, wmma::mem_row_major);
    }
    // 5. dQ_tile = dS K -> f_s columns 0..63 (warps 0-3, one 16-column tile
    //    each).  f_s is free: step 3 read it before the barrier above.
    if (warp < 4) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < s_pad; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, k_s + kk * kLdH + warp * 16, kLdH);
        wmma::load_matrix_sync(fa, ds_s + kk, kLdPt);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(f_s + warp * 16, acc, kLdF, wmma::mem_row_major);
    }
    __syncthreads();

    // 6. dq rows, scaled and rounded to bf16, rows >= S zero.
    if (tid < kBwdQTile * 8) {
      const int r = tid >> 3;
      const int c = (tid & 7) * 8;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f_s[r * kLdF + c + e] * scale;
      *reinterpret_cast<uint4*>(&dq_s[(q0 + r) * kLdH + c]) = q0 + r < S ? pack8(f) : zero;
    }
    __syncthreads();
  }

  // dk (scaled) and dv, all S16 rows (the accumulators' rows >= S are zero),
  // rounded to bf16 into the Q and K regions, which the loop above no longer
  // reads.
  for (int i = tid; i < s_pad * 8; i += kBwdThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    float fk[8], fv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      fk[e] = dk_s[r * kLdAcc + c + e] * scale;
      fv[e] = dv_s[r * kLdAcc + c + e];
    }
    *reinterpret_cast<uint4*>(&q_s[r * kLdH + c]) = pack8(fk);
    *reinterpret_cast<uint4*>(&k_s[r * kLdH + c]) = pack8(fv);
  }
  __syncthreads();
}

// Where attention_bwd_head leaves the head's dq.
__device__ __forceinline__ bf16* bwd_dq_tile(unsigned char* bwd_smem) {
  return reinterpret_cast<bf16*>(bwd_smem + kBwdDqOffset);
}

}  // namespace
}  // namespace demo2
