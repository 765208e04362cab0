// Attention backward from the saved probabilities, packed qkv layout.
//
// Replaces the Pallas kernels demo2_tpu/ops/packed_attention.py::
// _bwd_saved_db_kernel (reached through _packed_bwd_saved_db, which the
// training backward fused_block.py::_fused_bwd calls) and ::_bwd_saved_kernel
// (the same without db, reached through _packed_bwd_saved), with their
// numerics.  Kernels 4 and 7 are attention_regs_bwd_kernel<Probs::kSaved, kDb>
// of attention_regs_bwd.cuh, which holds the arithmetic, the design and what
// bounds it on the card: a (sample, head)'s Q, K, V, dO and saved P leave
// device memory once (four TMA tile copies and one bulk copy), and one warp
// carries 16 query rows, or 16 keys, with dP and dS in registers.  Kernel 7 is
// the same instantiation with the db sums compiled out, so its dqkv equals
// kernel 4's bit for bit.  Past the register tiles' 144 tokens (up to 256:
// the CLIP flagship at stride 12, 211 tokens) the _wide entries run the same
// arithmetic as block_wide_bwd_kernel<kDb> (attention_wide_block.cuh), with P
// read from device memory by 16-row and 16-column strips, and kernel 8 routes
// its first stage there.
// With db (kernel 4), db_qkv = the f32 column sums of the bf16-rounded dq,
// dk and dv, as _bwd_saved_db_kernel sums them.  The sums are deterministic:
// inside the kernel the tasks of a (sample, head) add their column sums in
// task order into a (B, 3C) f32 buffer, and a second small kernel adds the B
// partials in a fixed order.  No atomics, so db does not vary from run to run.
//
// Layouts: qkv (B*S, 3C) bf16, q | k | v, each head-major (H, 64) inside its
// C slice; dO (B*S, C) bf16; probs (B, H, S, S16) bf16 with S16 = S rounded up
// to 16 and zero columns >= S (demo2_tpu_torch/ops/packed_attention.py, the
// one definition of that layout; fused_attention_block.cu writes it).
//
// Kernel 8, the attention backward fused with the backward of the qkv
// projection, replaces the Pallas kernel demo2_tpu/ops/packed_attention.py::
// _bwd_fused_dw_kernel (reached through _packed_bwd_fused_dw), with its
// numerics: dq, dk, dv as kernel 4 computes them, rounded to bf16, and only
// then contracted (W and dW in torch's Linear layout (3C, C), t (B*S, C) the
// projection's input):
//   dt[row, :] = bf16(sum over the 3C columns of dqkv[row, j] W[j, :]),  the
//                f32 sum over the whole 3C rounded once;
//   dW[j, :]   = sum over the B*S rows of dqkv[row, j] t[row, :]         (f32);
//   db[j]      = sum over the B*S rows of dqkv[row, j]                   (f32).
// The TPU kept an (8 samples x S, 3C) dqkv block in 100 MiB of VMEM and walked
// the batch in order, carrying dW from one grid step to the next.  On an H100
// neither sum fits an SM: dt sums over the heads (a sample's 144 x 768 f32 is
// 442 KB), dW over all B*S rows (7 MB of f32 at ViT-B).  The first design
// kept one head's dqkv in shared memory and paid with ~4.7 GB of f32 partial
// sums (dt's 1 GB per head written and read, dW's per sample through L2); it
// took 4.50 ms at qkv (192, 129, 2304).  Here dqkv goes through device memory
// once, in bf16 (114 MB at that shape: written once, read twice), in three
// stages on the caller's stream, each a kernel of this library:
//   1. kernel 4's instantiation (launch_saved<true>): dqkv into scratch and
//      db's per-sample partials, then db_reduce_kernel, so kernel 8's db is
//      kernel 4's bit for bit;
//   2. dt = dqkv W on gemm_sm90.cuh: A K-major, W MN-major (read as it lies,
//      no transposed copy), RoundEpilogue: the whole K = 3C in one f32
//      accumulator, rounded to bf16 once, no split;
//   3. dW = dqkv^T t on gemm_sm90.cuh, both operands MN-major, K = B*S cut
//      into slices of `slice_rows` rows (a fixed number, chosen from the
//      shape by the wrapper), each (slice, tile) storing its f32 partial
//      (F32Epilogue), then sum_slices_kernel adds the partials in slice order.
// Every sum is taken in a fixed order, no atomics: reruns are bit-identical.
// What bounds it on an H100: at qkv (192, 129, 2304) the function must move
// qkv, probs, dO, t and W in and dt, dW and db out (~325 MB, 0.10 ms at 3.35
// TB/s) and count 8 B H S^2 D + 4 (B S) C 3C = 1.95e11 operations, 0.197 ms at
// the 989 TFLOP/s bf16 peak: operations.  The stages' own floor is the sum of
// their bounds: 0.105 ms (stage 1, bytes) + 0.089 + 0.089 (the two products,
// 87.7 GFLOP each) = 0.28 ms, plus the slice sum's bytes.

#include "attention_regs_bwd.cuh"
#include "attention_wide_block.cuh"
#include "gemm_sm90.cuh"

namespace demo2 {
namespace {

// db[j] = sum over b of partial[b, j] in a fixed order: a block takes 32
// columns, its eight warps an eighth of the samples each, in order, and the
// eight sums are then added in order.
constexpr int kDbReduceWarps = 8;

__global__ void __launch_bounds__(kDbReduceWarps * 32)
db_reduce_kernel(const float* __restrict__ partial, float* __restrict__ db, int batch, int n) {
  __shared__ float sums[kDbReduceWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;
  const int per_warp = (batch + kDbReduceWarps - 1) / kDbReduceWarps;
  const int b1 = min(batch, (warp + 1) * per_warp);
  float s = 0.f;
  if (j < n) {
    for (int b = warp * per_warp; b < b1; ++b) s += partial[static_cast<size_t>(b) * n + j];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < n) {
    for (int w = 1; w < kDbReduceWarps; ++w) s += sums[w][lane];
    db[j] = s;
  }
}

cudaError_t reduce_db(const void* db_partial, void* db, int batch, int width, cudaStream_t st) {
  const int n = 3 * width;
  db_reduce_kernel<<<(n + 31) / 32, kDbReduceWarps * 32, 0, st>>>(
      static_cast<const float*>(db_partial), static_cast<float*>(db), batch, n);
  return cudaGetLastError();
}

// Kernels 4 and 7 on the packed qkv (B*S, 3C) and dO (B*S, C): `wide`, the
// form past the register tiles (block_wide_bwd_kernel, attention_wide_block.cuh:
// heads of 64, 1 <= S <= 256), else the register tiles (S <= kMaxSeq).
template <bool kDb>
cudaError_t launch_saved(const void* qkv, const void* probs, const void* dout, void* dqkv,
                         void* db_partial, int batch, int seq, int width, int heads,
                         float scale, bool wide, cudaStream_t st) {
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* dx = static_cast<bf16*>(dqkv);
  if (wide) {
    return launch_block_wide_bwd<kDb>(x, static_cast<const bf16*>(probs),
                                      static_cast<const bf16*>(dout), dx,
                                      static_cast<float*>(db_partial), batch, seq, width, heads,
                                      scale, st);
  }
  if (width != heads * kHeadDim || seq > kMaxSeq) return cudaErrorInvalidValue;
  const HeadLayout packed = packed_layout(seq, width);
  return launch_attention_regs_bwd<Probs::kSaved, kDb>(
      x, x + width, x + 2 * width, packed, static_cast<const bf16*>(dout),
      rows_layout(seq, width), dx, dx + width, dx + 2 * width, packed, batch, seq, heads, scale,
      st, static_cast<const bf16*>(probs), static_cast<float*>(db_partial));
}

// out[i] = sum over s of partial[s, i], s in order; four values a thread.
__global__ void sum_slices_kernel(const float4* __restrict__ partial, float4* __restrict__ out,
                                  int slices, size_t n4) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = partial[i];
  for (int s = 1; s < slices; ++s) {
    const float4 v = partial[static_cast<size_t>(s) * n4 + i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[i] = acc;
}

// Kernel 8's three stages (the header comment above).
cudaError_t fused_dw(const void* qkv, const void* probs, const void* dout, const void* t,
                     const void* wqkv, void* dt, void* dwqkv, void* dbqkv, void* dqkv,
                     void* db_partial, void* dw_partial, int batch, int seq, int width,
                     int heads, int slice_rows, float scale, cudaStream_t st) {
  if (slice_rows <= 0 || slice_rows % kGemmBK != 0 || width % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = launch_saved<true>(qkv, probs, dout, dqkv, db_partial, batch, seq, width,
                                       heads, scale, seq > kMaxSeq, st);
  if (err != cudaSuccess) return err;
  err = reduce_db(db_partial, dbqkv, batch, width, st);
  if (err != cudaSuccess) return err;

  const int rows = batch * seq;
  const bf16* d = static_cast<const bf16*>(dqkv);
  err = launch_gemm_sm90<RoundEpilogue, Major::kK, Major::kMN>(
      d, static_cast<const bf16*>(wqkv), nullptr, static_cast<bf16*>(dt), nullptr, rows, width,
      3 * width, st);
  if (err != cudaSuccess) return err;

  const int slices = (rows + slice_rows - 1) / slice_rows;
  float* dw = static_cast<float*>(dwqkv);
  err = launch_gemm_sm90<F32Epilogue, Major::kMN, Major::kMN>(
      d, static_cast<const bf16*>(t), nullptr, nullptr, nullptr, 3 * width, width, rows, st,
      slices == 1 ? dw : static_cast<float*>(dw_partial), slice_rows);
  if (err != cudaSuccess || slices == 1) return err;
  const size_t n4 = static_cast<size_t>(3) * width * width / 4;
  sum_slices_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float4*>(dw_partial), reinterpret_cast<float4*>(dw), slices, n4);
  return cudaGetLastError();
}

}  // namespace
}  // namespace demo2

// Plain C entries, loaded with ctypes.  qkv (B*S, 3C), probs (B, H, S, S16)
// and dout (B*S, C) are bf16 device pointers, dqkv (B*S, 3C) bf16 output.
// Each returns the first non-zero cudaGetLastError() of its launches, else 0.
//
// Kernel 4: also db (3C,) f32, through db_partial (B, 3C) f32 scratch.  The
// _wide entries take heads of 64 over 1 <= S <= 256, the others S <= 144.
static int saved_db(const void* qkv, const void* probs, const void* dout, void* dqkv,
                    void* db_partial, void* db, int batch, int seq, int width, int heads,
                    float scale, bool wide, void* stream) {
  using namespace demo2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_saved<true>(qkv, probs, dout, dqkv, db_partial, batch, seq, width,
                                       heads, scale, wide, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_db(db_partial, db, batch, width, st));
}

extern "C" int demo2_attention_bwd_saved_db(const void* qkv, const void* probs,
                                            const void* dout, void* dqkv, void* db_partial,
                                            void* db, int batch, int seq, int width, int heads,
                                            float scale, void* stream) {
  return saved_db(qkv, probs, dout, dqkv, db_partial, db, batch, seq, width, heads, scale,
                  false, stream);
}

extern "C" int demo2_attention_bwd_saved_db_wide(const void* qkv, const void* probs,
                                                 const void* dout, void* dqkv, void* db_partial,
                                                 void* db, int batch, int seq, int width,
                                                 int heads, float scale, void* stream) {
  return saved_db(qkv, probs, dout, dqkv, db_partial, db, batch, seq, width, heads, scale,
                  true, stream);
}

// Kernel 7: dqkv only.
extern "C" int demo2_attention_bwd_saved(const void* qkv, const void* probs, const void* dout,
                                         void* dqkv, int batch, int seq, int width, int heads,
                                         float scale, void* stream) {
  using namespace demo2;
  return static_cast<int>(launch_saved<false>(qkv, probs, dout, dqkv, nullptr, batch, seq,
                                              width, heads, scale, false,
                                              static_cast<cudaStream_t>(stream)));
}

extern "C" int demo2_attention_bwd_saved_wide(const void* qkv, const void* probs,
                                              const void* dout, void* dqkv, int batch, int seq,
                                              int width, int heads, float scale, void* stream) {
  using namespace demo2;
  return static_cast<int>(launch_saved<false>(qkv, probs, dout, dqkv, nullptr, batch, seq,
                                              width, heads, scale, true,
                                              static_cast<cudaStream_t>(stream)));
}

// Kernel 8 (its first stage kernel 4's register form at S <= 144, its wide
// form up to 256): t (B*S, C) and wqkv (3C, C) bf16 inputs besides; dt (B*S, C) bf16,
// dwqkv (3C, C) and dbqkv (3C,) f32 outputs; dqkv (B*S, 3C) bf16, db_partial
// (B, 3C) f32 and, where B*S > slice_rows (a multiple of 64), dw_partial
// (ceil(B*S / slice_rows), 3C, C) f32 scratch.
extern "C" int demo2_attention_bwd_fused_dw(const void* qkv, const void* probs,
                                            const void* dout, const void* t, const void* wqkv,
                                            void* dt, void* dwqkv, void* dbqkv, void* dqkv,
                                            void* db_partial, void* dw_partial, int batch,
                                            int seq, int width, int heads, int slice_rows,
                                            float scale, void* stream) {
  return static_cast<int>(demo2::fused_dw(qkv, probs, dout, t, wqkv, dt, dwqkv, dbqkv, dqkv,
                                          db_partial, dw_partial, batch, seq, width, heads,
                                          slice_rows, scale, static_cast<cudaStream_t>(stream)));
}
