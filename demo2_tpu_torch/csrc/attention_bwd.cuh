// The attention backward kernel of the saved-probs backward
// (attention_bwd.cu: kernels 4 and 7; attention_bwd_fused_dw.cu: kernel 8)
// and of the first design of the packed self-attention backward
// (packed_attention.cu: demo2_packed_attention_bwd_first, kept for the timing
// beside kernel 6, which runs on attention_regs_bwd.cuh as the head-major
// kernel 10 does).  Per (sample, head), from bf16 q, k, v and dO:
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - rowsum(dP * P))   (f32, from
//   dP and P, not through dO.O);  dQ = dS K * scale;  dK = dS^T Q * scale;
//   dq, dk, dv rounded to bf16.
// Where P comes from and where it is rounded is the Probs mode, a template
// parameter of both designs, listed at the enum below.
// With kDb (kSaved only: kernel 4) the f32 column sums of the rounded dq,
// dk, dv of the (sample, head) go to db_partial (B, 3C), which
// attention_bwd.cu adds up over B in a fixed order: no atomics.
// With kOnChip (kSaved only: kernel 8, attention_bwd_fused_dw.cu) the rounded
// dq, dk, dv never leave the SM: they stay in shared memory as bf16 tiles
// (rows >= S zero) for the products that follow in the same block.
//
// Layouts: q, k, v through HeadLayout `in`, dO through `dol`, dq, dk, dv
// through `outl` (attention_fwd.cuh); probs (B, H, S, S16) bf16, S16 = S
// rounded up to 16, zero columns >= S (demo2_tpu_torch/ops/packed_attention.py,
// the one definition of that layout).
//
// Design: one 256-thread block (8 warps) per (head, sample).  Q, K, V and dO
// of the head (<= 144 x 64 bf16 each) and f32 dK / dV accumulators live in
// shared memory (180-200 KB of the SM's 227 KB, so one block per SM); the
// queries are walked in 16-row tiles.  dK and dV sum over every query row,
// so keeping the whole sequence in one block needs no second pass over the
// queries.  Per tile: [recompute: S = Q_tile K^T (wmma) -> softmax rows on
// CUDA cores, all keys at hand] dP (wmma) -> dS on CUDA cores, one warp per
// 2 rows -> dV += P^T dO and dK += dS^T Q (wmma, accumulators loaded from
// and stored to shared memory) and dQ = dS K (wmma) -> bf16 rows of dq.
//
// What bounds it on an H100: at the ViT-B shape (B = 192, S = 129, 12 heads
// of 64) the kernel reads q, k, v and dO (152 MB; the saved probs another 86
// MB) and writes dq, dk, dv (114 MB): ~0.1 ms at the card's 3.35 TB/s.  Its
// 2 x 4 x 129 x 144 x 64 FLOP per (sample, head), ~22 GFLOP in all (the
// recomputed QK^T adds a fifth product), run through simple wmma tiles with one block per SM; the
// shared-memory traffic of those tiles, not device memory, bounds this
// first version.  wgmma with register accumulators is later work.

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
constexpr int kLdF = kMaxSeq + 4;       // f32 rows of the S / dP tile, dQ staging, f32 p
constexpr int kHeadElems = kMaxSeq * kLdH;
constexpr int kAccElems = kMaxSeq * kLdAcc;
constexpr int kPTileElems = kBwdQTile * kLdPt;
constexpr int kFTileElems = kBwdQTile * kLdF;

// Where P comes from and where the backward rounds, and which header
// instantiates the mode:
//   kSaved (packed_attention.py::_bwd_saved(_db)_kernel, kernels 4, 7 and 8;
//       this file): P is the forward's saved bf16 p; dS uses that bf16 p and
//       is rounded to bf16 before the dQ / dK products;
//   kRecompute (packed_attention.py::_bwd_kernel; kernel 6 on
//       attention_regs_bwd.cuh, its first design on this file): p is
//       recomputed from Q and K in f32 (exp(s - max) / (sum + 1e-30)); dV
//       takes bf16(p), dS takes the f32 p and is rounded to bf16 before the
//       dQ / dK products;
//   kRecomputeF32 (flash_attention.py::_bwd_kernel, kernel 10;
//       attention_regs_bwd.cuh only): f32 throughout.
enum class Probs { kSaved, kRecompute, kRecomputeF32 };

// Shared memory of one block: Q, K, V, dO; dK, dV; the P and dS tiles; the
// f32 tile; [recompute] the f32 p tile; [on chip] the bf16 dq of the head.
__host__ __device__ constexpr int bwd_smem_bytes(Probs mode, bool on_chip = false) {
  return 4 * kHeadElems * 2 + 2 * kAccElems * 4 + 2 * kPTileElems * 2 + kFTileElems * 4 +
         (mode != Probs::kSaved ? kFTileElems * 4 : 0) + (on_chip ? kHeadElems * 2 : 0);
}
static_assert(bwd_smem_bytes(Probs::kSaved) == 180480, "kernel 4's footprint");
static_assert(bwd_smem_bytes(Probs::kRecompute) <= 232448 &&
                  bwd_smem_bytes(Probs::kSaved, true) <= 232448,
              "the block must fit one SM's shared memory");
static_assert((kHeadElems * 2) % 128 == 0 && (kAccElems * 4) % 128 == 0 &&
                  (kPTileElems * 2) % 128 == 0 && (kFTileElems * 4) % 128 == 0,
              "wmma needs 32-byte aligned tiles");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The backward of one (sample b, head h) by the whole block.  With kOnChip
// nothing is written to dq / dk / dv: on return (after a block barrier) the
// bf16 dq, dk and dv of the head, rows < S16 and rows >= S zero, lie in
// shared memory at bwd_dq_tile(), the Q region and the K region, each
// [row * kLdH + d]; every other region is free.
template <Probs kMode, bool kDb, bool kOnChip>
__device__ __forceinline__ void attention_bwd_head(
    unsigned char* bwd_smem, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, HeadLayout in, const bf16* __restrict__ dout, HeadLayout dol,
    const bf16* __restrict__ probs, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, HeadLayout outl, float* __restrict__ db_partial, int S, float scale,
    int h, int b, int heads) {
  using namespace nvcuda;
  static_assert(kMode != Probs::kRecomputeF32, "f32 probabilities: attention_regs_bwd.cuh");
  constexpr bool kRecompute = kMode == Probs::kRecompute;
  static_assert(!(kDb && kRecompute), "db is kernel 4's, from saved probs");
  static_assert(!(kOnChip && (kRecompute || kDb)), "kernel 8 reads saved probs, sums db itself");
  bf16* q_s = reinterpret_cast<bf16*>(bwd_smem);
  bf16* k_s = q_s + kHeadElems;
  bf16* v_s = k_s + kHeadElems;
  bf16* do_s = v_s + kHeadElems;
  float* dk_s = reinterpret_cast<float*>(do_s + kHeadElems);
  float* dv_s = dk_s + kAccElems;
  bf16* p_s = reinterpret_cast<bf16*>(dv_s + kAccElems);
  bf16* ds_s = p_s + kPTileElems;
  float* f_s = reinterpret_cast<float*>(ds_s + kPTileElems);
  float* pf_s = f_s + kFTileElems;                                     // kRecompute
  constexpr int kDqOffset = bwd_smem_bytes(kMode);
  bf16* dq_s = reinterpret_cast<bf16*>(bwd_smem + kDqOffset);          // kOnChip

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s_pad = (S + 15) & ~15;
  const size_t src = in.at(b, h);
  const size_t do_src = dol.at(b, h);
  const size_t dst = outl.at(b, h);
  const bf16* p_src =
      kRecompute ? nullptr : probs + (static_cast<size_t>(b) * heads + h) * S * s_pad;

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
  float dq_sum = 0.f;  // kDb: thread tid < 64 sums dq column tid
  __syncthreads();

  const int vecs = s_pad / 8;
  const int key_tiles = s_pad / 16;
  const int rows_per_warp = kBwdQTile / kBwdWarps;
  for (int q0 = 0; q0 < S; q0 += kBwdQTile) {
    if (kRecompute) {
      // 1a. S = Q_tile K^T -> f_s: the warps split the key tiles.
      for (int nt = warp; nt < key_tiles; nt += kBwdWarps) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < kHeadDim; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, q_s + q0 * kLdH + kk, kLdH);
          wmma::load_matrix_sync(fb, k_s + nt * 16 * kLdH + kk, kLdH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(f_s + nt * 16, acc, kLdF, wmma::mem_row_major);
      }
      __syncthreads();
      // 1b. p = exp(s * scale - max) / (sum + 1e-30) over the S keys, in f32
      //     (pf_s), and its bf16 rounding (p_s); zero past S and in query
      //     rows >= S.
#pragma unroll
      for (int rr = 0; rr < rows_per_warp; ++rr) {
        const int r = warp * rows_per_warp + rr;
        const bool live = q0 + r < S;
        float* srow = f_s + r * kLdF;
        float m = -INFINITY;
        for (int j = lane; j < S; j += 32) {
          const float val = srow[j] * scale;
          srow[j] = val;
          m = fmaxf(m, val);
        }
        m = warp_max(m);
        float sum = 0.f;
        for (int j = lane; j < S; j += 32) {
          const float e = expf(srow[j] - m);
          srow[j] = e;
          sum += e;
        }
        const float denom = warp_sum(sum) + 1e-30f;
        for (int j = lane; j < s_pad; j += 32) {
          const float p = (live && j < S) ? srow[j] / denom : 0.f;
          pf_s[r * kLdF + j] = p;
          p_s[r * kLdPt + j] = __float2bfloat16_rn(p);
        }
      }
      __syncthreads();
    } else {
      // 1. The saved P tile: 16 query rows x S16 keys, rows >= S zero.
      for (int i = tid; i < kBwdQTile * vecs; i += kBwdThreads) {
        const int r = i / vecs;
        const int c = (i - r * vecs) * 8;
        *reinterpret_cast<uint4*>(&p_s[r * kLdPt + c]) =
            q0 + r < S
                ? *reinterpret_cast<const uint4*>(p_src + static_cast<size_t>(q0 + r) * s_pad + c)
                : zero;
      }
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

    // 3. dS = P * (dP - rowsum(dP * P)) in f32 (P: the saved bf16 p, or the
    //    recomputed f32 p), rounded to bf16: warp w owns rows 2w and 2w + 1.
    //    Columns >= S have P = 0, so dS = 0 there.
#pragma unroll
    for (int rr = 0; rr < rows_per_warp; ++rr) {
      const int r = warp * rows_per_warp + rr;
      const float* dp = f_s + r * kLdF;
      auto p_at = [&](int j) {
        return kRecompute ? pf_s[r * kLdF + j] : __bfloat162float(p_s[r * kLdPt + j]);
      };
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

    // 6. dq rows < S, scaled and rounded to bf16; with db, the rounded values
    //    go back to f_s for the column sums (rows >= S as zeros).
    if (tid < kBwdQTile * 8) {
      const int r = tid >> 3;
      const int c = (tid & 7) * 8;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f_s[r * kLdF + c + e] * scale;
      if (q0 + r < S) {
        const uint4 u = pack8(f);
        if (kOnChip) {
          *reinterpret_cast<uint4*>(&dq_s[(q0 + r) * kLdH + c]) = u;
        } else {
          *reinterpret_cast<uint4*>(dq + dst + static_cast<size_t>(q0 + r) * outl.row + c) = u;
        }
        if (kDb) unpack8(u, f);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.f;
        if (kOnChip) *reinterpret_cast<uint4*>(&dq_s[(q0 + r) * kLdH + c]) = zero;
      }
      if (kDb) {
#pragma unroll
        for (int e = 0; e < 8; ++e) f_s[r * kLdF + c + e] = f[e];
      }
    }
    if (kDb) {
      __syncthreads();
      if (tid < kHeadDim) {
        for (int r = 0; r < kBwdQTile; ++r) dq_sum += f_s[r * kLdF + tid];
      }
    }
    __syncthreads();
  }

  // dk (scaled) and dv rows < S, rounded to bf16.  On chip: all S16 rows (the
  // accumulators' rows >= S are zero), into the Q and K regions, which the
  // loop above no longer reads.
  for (int i = tid; i < (kOnChip ? s_pad : S) * 8; i += kBwdThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    float fk[8], fv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      fk[e] = dk_s[r * kLdAcc + c + e] * scale;
      fv[e] = dv_s[r * kLdAcc + c + e];
    }
    if (kOnChip) {
      *reinterpret_cast<uint4*>(&q_s[r * kLdH + c]) = pack8(fk);
      *reinterpret_cast<uint4*>(&k_s[r * kLdH + c]) = pack8(fv);
    } else {
      const size_t row = dst + static_cast<size_t>(r) * outl.row + c;
      *reinterpret_cast<uint4*>(dk + row) = pack8(fk);
      *reinterpret_cast<uint4*>(dv + row) = pack8(fv);
    }
  }
  if (kOnChip) __syncthreads();

  if (kDb) {
    // Column sums of the rounded dq, dk, dv of this (head, sample), rows in
    // order: threads 0-63 take dq and dk column tid, threads 64-127 dv.
    const int C = heads * kHeadDim;
    float* part = db_partial + static_cast<size_t>(b) * 3 * C + h * kHeadDim;
    if (tid < kHeadDim) {
      float dk_sum = 0.f;
      for (int r = 0; r < S; ++r) dk_sum += round_bf16(dk_s[r * kLdAcc + tid] * scale);
      part[tid] = dq_sum;
      part[C + tid] = dk_sum;
    } else if (tid < 2 * kHeadDim) {
      const int c = tid - kHeadDim;
      float dv_sum = 0.f;
      for (int r = 0; r < S; ++r) dv_sum += round_bf16(dv_s[r * kLdAcc + c]);
      part[2 * C + c] = dv_sum;
    }
  }
}

// Where attention_bwd_head<Probs::kSaved, false, true> leaves the head's dq.
__device__ __forceinline__ bf16* bwd_dq_tile(unsigned char* bwd_smem) {
  constexpr int kDqOffset = bwd_smem_bytes(Probs::kSaved);
  return reinterpret_cast<bf16*>(bwd_smem + kDqOffset);
}

// One block per (head, sample).
template <Probs kMode, bool kDb>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, HeadLayout in, const bf16* __restrict__ dout,
                     HeadLayout dol, const bf16* __restrict__ probs, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, HeadLayout outl,
                     float* __restrict__ db_partial, int S, float scale) {
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  attention_bwd_head<kMode, kDb, false>(bwd_smem, q, k, v, in, dout, dol, probs, dq, dk, dv,
                                        outl, db_partial, S, scale, blockIdx.x, blockIdx.y,
                                        gridDim.x);
}

template <Probs kMode, bool kDb>
cudaError_t launch_attention_bwd(const bf16* q, const bf16* k, const bf16* v, HeadLayout in,
                                 const bf16* dout, HeadLayout dol, const bf16* probs, bf16* dq,
                                 bf16* dk, bf16* dv, HeadLayout outl, float* db_partial,
                                 int batch, int seq, int heads, float scale, cudaStream_t st) {
  auto kernel = attention_bwd_kernel<kMode, kDb>;
  constexpr int smem = bwd_smem_bytes(kMode);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, batch), kBwdThreads, smem, st>>>(q, k, v, in, dout, dol, probs, dq, dk,
                                                         dv, outl, db_partial, seq, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2
