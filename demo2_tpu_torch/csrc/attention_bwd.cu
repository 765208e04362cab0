// Attention backward from the saved probabilities, packed qkv layout.
//
// Replaces the Pallas kernels demo2_tpu/ops/packed_attention.py::
// _bwd_saved_db_kernel (reached through _packed_bwd_saved_db, which the
// training backward fused_block.py::_fused_bwd calls) and ::_bwd_saved_kernel
// (the same without db, reached through _packed_bwd_saved), with their
// numerics: attention_bwd_kernel<Probs::kSaved> of attention_bwd.cuh, which
// holds the arithmetic, the design and what bounds it on the card.
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

#include "attention_bwd.cuh"

namespace demo2 {
namespace {

// db[j] = sum over b of partial[b, j], b in order.
__global__ void db_reduce_kernel(const float* __restrict__ partial, float* __restrict__ db,
                                 int batch, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < batch; ++b) s += partial[static_cast<size_t>(b) * n + j];
  db[j] = s;
}

// Kernels 4 and 7 on the packed qkv (B*S, 3C) and dO (B*S, C).
template <bool kDb>
cudaError_t launch_saved(const void* qkv, const void* probs, const void* dout, void* dqkv,
                         void* db_partial, int batch, int seq, int width, int heads,
                         float scale, cudaStream_t st) {
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* dx = static_cast<bf16*>(dqkv);
  const HeadLayout packed = packed_layout(seq, width);
  return launch_attention_bwd<Probs::kSaved, kDb>(
      x, x + width, x + 2 * width, packed, static_cast<const bf16*>(dout),
      rows_layout(seq, width), static_cast<const bf16*>(probs), dx, dx + width, dx + 2 * width,
      packed, static_cast<float*>(db_partial), batch, seq, heads, scale, st);
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
  cudaError_t err = launch_saved<true>(qkv, probs, dout, dqkv, db_partial, batch, seq, width,
                                       heads, scale, st);
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
  return static_cast<int>(launch_saved<false>(qkv, probs, dout, dqkv, nullptr, batch, seq,
                                              width, heads, scale,
                                              static_cast<cudaStream_t>(stream)));
}
