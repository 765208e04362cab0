// The attention ablation tool's kernel: the packed self-attention forward
// with parts of its work left out, to see on the card where the time of the
// attention forward in use goes (loads and store, QK^T, PV, softmax): the
// register-resident task stream of kernels 5 and 9, attention_regs_fwd.cuh.
//
// Replaces the Pallas kernel that tools/bench_kernel_ablate.py::make_kernel
// builds, with its cases and their numerics (:32-52).  qkv (B*S, 3C) bf16 ->
// out (B*S, C) bf16; the first `heads` heads are computed, the output columns
// of the others are left as the caller gave them:
//   full         scores * 0.125, keys >= `keys` masked (the tool masks 129 of
//                its 136), the unnormalised exp rounded to bf16 for PV, the
//                f32 result divided by (rowsum + 1e-30): kernel 5's
//                instantiation, attention_regs_fwd_kernel<Softmax::kNormAfterPV>,
//                as it is, with the key count passed in;
//   no_softmax   p = bf16(s * 0.01) on the unscaled, unmasked scores, PV,
//                no division: no max, exp or sums;
//   scores_only  out = bf16(s[:, :64]), the raw scores of the first 64 keys:
//                QK^T over all keys as the tool computes it, no V, no PV;
//   slice_only   out = bf16(bf16(q + k) + v): the loads and the store alone.
// Each case leaves its work out; none computes it and throws it away.
//
// Design: every case is a form of attention_regs_fwd_kernel (its second
// template parameter, Ablate): a (sample, head)'s Q, K [and V] come in once
// by TMA into the ring of four items, one warp carries 16 query rows with the
// scores in registers, sixteen warps take a block's tasks in turn.  So the
// difference between two cases is the work one of them leaves out, in the
// kernel the port runs.  (Until the tool moved here its cases kept the first
// design's tiling, one 128-thread block per 16 query rows with the scores in
// shared memory, which read 0.3205 ms: loads and store 0.0756, QK^T 0.0627,
// PV 0.1038, softmax 0.0784, one after another between barriers.)  The cases
// overlap inside a block as the forward's stages do, so their differences say
// what each stage adds to the stream, not what it would take alone.
//
// What bounds it on an H100: every case reads qkv (120 MB at (192, 136,
// 2304)) and writes out (40 MB; a third with 4 heads): 0.048 ms at 3.35 TB/s,
// by bytes; the full case's 4 B S^2 C = 10.9 GFLOP are 0.011 ms at the bf16
// peak.  scores_only asks the copy engine for Q and K alone (80 MB).

#include "attention_regs_fwd.cuh"

namespace demo2 {
namespace {

template <Ablate kAblate>
cudaError_t launch_ablate(const bf16* x, bf16* out, int batch, int seq, int width, int heads,
                          int keys, cudaStream_t st) {
  return launch_attention_regs_fwd<Softmax::kNormAfterPV, kAblate>(
      x, x + width, x + 2 * width, packed_layout(seq, width), out, rows_layout(seq, width), batch,
      seq, heads, 0.125f, st, keys);
}

}  // namespace
}  // namespace demo2

// Plain C entry, loaded with ctypes.  qkv (B*S, 3C) and out (B*S, C) are bf16
// device pointers; mode 0 full, 1 no_softmax, 2 scores_only, 3 slice_only;
// `keys` <= seq the valid keys of the full case; `heads` <= width / 64 the
// heads computed.  Returns cudaGetLastError() of its launch, else 0; -1 for an
// unknown mode.
extern "C" int demo2_attention_ablate(const void* qkv, void* out, int batch, int seq, int width,
                                      int heads, int mode, int keys, void* stream) {
  using namespace demo2;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return static_cast<int>(
          launch_ablate<Ablate::kNone>(x, o, batch, seq, width, heads, keys, st));
    case 1:
      return static_cast<int>(
          launch_ablate<Ablate::kNoSoftmax>(x, o, batch, seq, width, heads, keys, st));
    case 2:
      return static_cast<int>(
          launch_ablate<Ablate::kScoresOnly>(x, o, batch, seq, width, heads, keys, st));
    case 3:
      return static_cast<int>(
          launch_ablate<Ablate::kSliceOnly>(x, o, batch, seq, width, heads, keys, st));
    default:
      return -1;
  }
}
