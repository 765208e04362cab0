// Attention backward from the saved probabilities, packed qkv layout.
//
// Replaces the Pallas kernels demo2_tpu/ops/packed_attention.py::
// _bwd_saved_db_kernel (reached through _packed_bwd_saved_db, which the
// training backward fused_block.py::_fused_bwd calls) and ::_bwd_saved_kernel
// (the same without db, reached through _packed_bwd_saved), with their
// numerics.  Per (sample, head), from bf16 q, k, v, dO and the saved bf16 p:
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - rowsum(dP * P))   (f32, from
//   dP and P, not through dO.O);  dQ = bf16(dS) K * scale;
//   dK = bf16(dS)^T Q * scale;  dq, dk, dv rounded to bf16 into the packed
//   (B*S, 3C) dqkv.
// With db (kernel 4), db_qkv = the f32 column sums of the bf16-rounded dq,
// dk and dv, as _bwd_saved_db_kernel sums them.  The sums are deterministic:
// each block writes its (head, sample) partial column sums into a (B, 3C) f32
// buffer, and a second small kernel adds the B partials in a fixed order.
// No atomics, so db does not vary from run to run.
//
// Layouts: qkv (B*S, 3C) bf16, q | k | v, each head-major (H, 64) inside its
// C slice; dO (B*S, C) bf16; probs (B, H, S, S16) bf16 with S16 = S rounded up
// to 16 and zero columns >= S (demo2_tpu_torch/ops/packed_attention.py, the
// one definition of that layout; fused_attention_block.cu writes it).
//
// Design: one 256-thread block (8 warps) per (head, sample).  Q, K, V and dO
// of the head (<= 144 x 64 bf16 each) and f32 dK / dV accumulators live in
// shared memory (180 KB of the SM's 227 KB, so one block per SM); P is
// streamed in 16-row query tiles.  dK and dV sum over every query row, so
// keeping the whole sequence in one block needs no second pass over the
// queries.  Per tile: dP (wmma) -> dS on CUDA cores, one warp per 2 rows ->
// dV += P^T dO and dK += dS^T Q (wmma, accumulators loaded from and stored to
// shared memory) and dQ = dS K (wmma) -> bf16 rows of dqkv.
//
// What bounds it on an H100: at the flagship shape (B = 192, S = 129, 12
// heads of 64) the kernel reads qkv (114 MB), dO (38 MB) and probs (86 MB)
// and writes dqkv (114 MB): ~0.35 GB, ~0.1 ms at the card's 3.35 TB/s.  Its
// 2 x 4 x 129 x 144 x 64 FLOP per (sample, head), ~22 GFLOP in all, run
// through simple wmma tiles with one block per SM; the shared-memory traffic
// of those tiles, not device memory, is what this first version is bound by.
// wgmma with register accumulators is later work.

#include <mma.h>

#include "gemm.cuh"

namespace demo2 {
namespace {

constexpr int kBwdHeadDim = 64;
constexpr int kBwdMaxSeq = 144;            // keys and queries, padded to 16
constexpr int kBwdQTile = 16;              // query rows per step (one wmma tile)
constexpr int kBwdThreads = 256;           // 8 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kLdH = kBwdHeadDim + 8;      // bf16 rows of Q, K, V, dO
constexpr int kLdAcc = kBwdHeadDim + 4;    // f32 rows of dK, dV
constexpr int kLdPt = kBwdMaxSeq + 8;      // bf16 rows of the P and dS tiles
constexpr int kLdF = kBwdMaxSeq + 4;       // f32 rows of the dP tile / dQ staging
constexpr int kHeadElems = kBwdMaxSeq * kLdH;
constexpr int kAccElems = kBwdMaxSeq * kLdAcc;
constexpr int kPTileElems = kBwdQTile * kLdPt;
constexpr int kBwdSmemBytes = 4 * kHeadElems * 2 + 2 * kAccElems * 4 + 2 * kPTileElems * 2 +
                              kBwdQTile * kLdF * 4;  // 180,480 B
static_assert(kBwdSmemBytes <= 232448, "the block must fit one SM's shared memory");
static_assert((kHeadElems * 2) % 128 == 0 && (kAccElems * 4) % 128 == 0 &&
                  (kPTileElems * 2) % 128 == 0,
              "wmma needs 32-byte aligned tiles");

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kDb>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_saved_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ probs,
                           const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                           float* __restrict__ db_partial, int S, int C, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(bwd_smem);
  bf16* k_s = q_s + kHeadElems;
  bf16* v_s = k_s + kHeadElems;
  bf16* do_s = v_s + kHeadElems;
  float* dk_s = reinterpret_cast<float*>(do_s + kHeadElems);
  float* dv_s = dk_s + kAccElems;
  bf16* p_s = reinterpret_cast<bf16*>(dv_s + kAccElems);
  bf16* ds_s = p_s + kPTileElems;
  float* f_s = reinterpret_cast<float*>(ds_s + kPTileElems);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int heads = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s_pad = (S + 15) & ~15;
  const size_t ld3 = 3 * static_cast<size_t>(C);
  const bf16* src = qkv + static_cast<size_t>(b) * S * ld3 + h * kBwdHeadDim;
  const bf16* do_src = dout + static_cast<size_t>(b) * S * C + h * kBwdHeadDim;
  const bf16* p_src = probs + (static_cast<size_t>(b) * heads + h) * S * s_pad;
  bf16* dst = dqkv + static_cast<size_t>(b) * S * ld3 + h * kBwdHeadDim;

  // Q, K, V, dO of the head, rows >= S zero; dK = dV = 0.
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < s_pad * 8; i += kBwdThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    const bool ok = r < S;
    const bf16* row = src + r * ld3 + c;
    *reinterpret_cast<uint4*>(&q_s[r * kLdH + c]) = ok ? *reinterpret_cast<const uint4*>(row) : zero;
    *reinterpret_cast<uint4*>(&k_s[r * kLdH + c]) =
        ok ? *reinterpret_cast<const uint4*>(row + C) : zero;
    *reinterpret_cast<uint4*>(&v_s[r * kLdH + c]) =
        ok ? *reinterpret_cast<const uint4*>(row + 2 * C) : zero;
    *reinterpret_cast<uint4*>(&do_s[r * kLdH + c]) =
        ok ? *reinterpret_cast<const uint4*>(do_src + r * C + c) : zero;
  }
  for (int i = tid; i < s_pad * kLdAcc; i += kBwdThreads) {
    dk_s[i] = 0.f;
    dv_s[i] = 0.f;
  }
  float dq_sum = 0.f;  // kDb: thread tid < 64 sums dq column tid
  __syncthreads();

  const int vecs = s_pad / 8;
  const int key_tiles = s_pad / 16;
  for (int q0 = 0; q0 < S; q0 += kBwdQTile) {
    // 1. The P tile: 16 query rows x S16 keys, rows >= S zero.
    for (int i = tid; i < kBwdQTile * vecs; i += kBwdThreads) {
      const int r = i / vecs;
      const int c = (i - r * vecs) * 8;
      *reinterpret_cast<uint4*>(&p_s[r * kLdPt + c]) =
          q0 + r < S ? *reinterpret_cast<const uint4*>(p_src + static_cast<size_t>(q0 + r) * s_pad + c)
                     : zero;
    }
    // 2. dP = dO_tile V^T -> f_s: the warps split the key tiles.
    for (int nt = warp; nt < key_tiles; nt += kBwdWarps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBwdHeadDim; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, do_s + q0 * kLdH + kk, kLdH);
        wmma::load_matrix_sync(fb, v_s + nt * 16 * kLdH + kk, kLdH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(f_s + nt * 16, acc, kLdF, wmma::mem_row_major);
    }
    __syncthreads();

    // 3. dS = P * (dP - rowsum(dP * P)) in f32, rounded to bf16: warp w owns
    //    rows 2w and 2w + 1.  Columns >= S have P = 0, so dS = 0 there.
#pragma unroll
    for (int rr = 0; rr < kBwdQTile / kBwdWarps; ++rr) {
      const int r = warp * (kBwdQTile / kBwdWarps) + rr;
      const float* dp = f_s + r * kLdF;
      const bf16* p = p_s + r * kLdPt;
      float sum = 0.f;
      for (int j = lane; j < s_pad; j += 32) sum += dp[j] * __bfloat162float(p[j]);
      sum = warp_sum(sum);
      for (int j = lane; j < s_pad; j += 32) {
        ds_s[r * kLdPt + j] = __float2bfloat16_rn(__bfloat162float(p[j]) * (dp[j] - sum));
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
      wmma::load_matrix_sync(fa, (is_k ? ds_s : p_s) + mt * 16, kLdPt);
      wmma::load_matrix_sync(fb, (is_k ? q_s : do_s) + q0 * kLdH + nt * 16, kLdH);
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
        wmma::load_matrix_sync(fa, ds_s + kk, kLdPt);
        wmma::load_matrix_sync(fb, k_s + kk * kLdH + warp * 16, kLdH);
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
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(q0 + r) * ld3 + c) = u;
        if (kDb) unpack8(u, f);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.f;
      }
      if (kDb) {
#pragma unroll
        for (int e = 0; e < 8; ++e) f_s[r * kLdF + c + e] = f[e];
      }
    }
    if (kDb) {
      __syncthreads();
      if (tid < kBwdHeadDim) {
        for (int r = 0; r < kBwdQTile; ++r) dq_sum += f_s[r * kLdF + tid];
      }
    }
    __syncthreads();
  }

  // dk (scaled) and dv rows < S, rounded to bf16.
  for (int i = tid; i < S * 8; i += kBwdThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    float fk[8], fv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      fk[e] = dk_s[r * kLdAcc + c + e] * scale;
      fv[e] = dv_s[r * kLdAcc + c + e];
    }
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld3 + C + c) = pack8(fk);
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld3 + 2 * C + c) = pack8(fv);
  }

  if (kDb) {
    // Column sums of the rounded dq, dk, dv of this (head, sample), rows in
    // order: threads 0-63 take dq and dk column tid, threads 64-127 dv.
    float* part = db_partial + static_cast<size_t>(b) * 3 * C + h * kBwdHeadDim;
    if (tid < kBwdHeadDim) {
      float dk_sum = 0.f;
      for (int r = 0; r < S; ++r) dk_sum += round_bf16(dk_s[r * kLdAcc + tid] * scale);
      part[tid] = dq_sum;
      part[C + tid] = dk_sum;
    } else if (tid < 2 * kBwdHeadDim) {
      const int c = tid - kBwdHeadDim;
      float dv_sum = 0.f;
      for (int r = 0; r < S; ++r) dv_sum += round_bf16(dv_s[r * kLdAcc + c]);
      part[2 * C + c] = dv_sum;
    }
  }
}

// db[j] = sum over b of partial[b, j], b in order.
__global__ void db_reduce_kernel(const float* __restrict__ partial, float* __restrict__ db,
                                 int batch, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < batch; ++b) s += partial[static_cast<size_t>(b) * n + j];
  db[j] = s;
}

template <bool kDb>
cudaError_t launch_attention_bwd(const void* qkv, const void* probs, const void* dout,
                                 void* dqkv, void* db_partial, int batch, int seq, int width,
                                 int heads, float scale, cudaStream_t st) {
  auto kernel = attention_bwd_saved_kernel<kDb>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, batch), kBwdThreads, kBwdSmemBytes, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(probs),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), static_cast<float*>(db_partial),
      seq, width, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2

// Plain C entries, loaded with ctypes.  qkv (B*S, 3C), probs (B, H, S, S16)
// and dout (B*S, C) are bf16 device pointers, dqkv (B*S, 3C) bf16 output.
// Each returns the first non-zero cudaGetLastError() of its launches, else 0.
//
// Kernel 4: also db (3C,) f32, through db_partial (B, 3C) f32 scratch.
extern "C" int demo2_attention_bwd_saved_db(const void* qkv, const void* probs,
                                            const void* dout, void* dqkv, void* db_partial,
                                            void* db, int batch, int seq, int width, int heads,
                                            float scale, void* stream) {
  using namespace demo2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_attention_bwd<true>(qkv, probs, dout, dqkv, db_partial, batch, seq,
                                               width, heads, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 3 * width;
  db_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(db_partial),
                                                     static_cast<float*>(db), batch, n);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 7: dqkv only.
extern "C" int demo2_attention_bwd_saved(const void* qkv, const void* probs, const void* dout,
                                         void* dqkv, int batch, int seq, int width, int heads,
                                         float scale, void* stream) {
  using namespace demo2;
  return static_cast<int>(launch_attention_bwd<false>(qkv, probs, dout, dqkv, nullptr, batch,
                                                      seq, width, heads, scale,
                                                      static_cast<cudaStream_t>(stream)));
}

extern "C" int demo2_attention_bwd_head_dim() { return demo2::kBwdHeadDim; }
extern "C" int demo2_attention_bwd_max_seq() { return demo2::kBwdMaxSeq; }
