"""The attention ablation tool (tools/bench_kernel_ablate.py): the packed
self-attention forward with parts of its work left out, timed on the card to
see where the attention kernels' time goes.

    python3 -m demo2_tpu_torch.tools.bench_kernel_ablate

times the five cases of the JAX tool at qkv (192, 136, 2304) bf16 with CUDA
events and prints one line each, beside the least time the card could take
for the case's bytes.  The JAX tool subtracts a fixed dispatch time that it
measured on its TPU; CUDA events time the kernel alone, so nothing is
subtracted here.

  ablate_attention(qkv, mode, heads): the kernel on CUDA tensors, the plain
      version on CPU tensors
      replaces the Pallas kernel of tools/bench_kernel_ablate.py::make_kernel
      (csrc/attention_ablate.cu, demo2_attention_ablate).

The cases, as the tool hard-codes them (:32-52), for the first `heads` heads:
  full         scores * 0.125, keys >= 129 masked, the unnormalised exp
               rounded to the compute dtype for PV, then / (rowsum + 1e-30);
  no_softmax   p = s * 0.01 on the unscaled, unmasked scores, PV, no division;
  scores_only  the raw scores of the first 64 keys;
  slice_only   q + k + v.
With fewer heads than the width holds, the Pallas kernel leaves the other
output columns unwritten; here they are zero.

On the card every case is a form of the packed self-attention's kernel
(csrc/attention_regs_fwd.cuh: a (sample, head)'s q, k and v loaded once, one
warp per 16 query rows with the scores in registers), so the cases split the
kernel the port runs.  Its stages overlap inside a block: the difference of
two cases is what a stage adds to the stream, not what it takes alone, and
scores_only does not load v at all.
"""

from __future__ import annotations

import subprocess

import torch

from ..ops.kernel_lib import check, expect
from ..ops.packed_attention import check_head_limits, merge_heads, split_heads

MODES = ("full", "no_softmax", "scores_only", "slice_only")
CASES = (("full", 12), ("full", 4), ("no_softmax", 12), ("scores_only", 12), ("slice_only", 12))
SHAPE = (192, 136, 2304)   # the tool's B, S, 3C
VALID_KEYS = 129           # the tool masks `key_ids < 129`
FULL_SCALE = 0.125
HEAD_DIM = 64
HBM_PEAK_TBS = 3.35        # H100 SXM data sheet


def _check_case(qkv, mode: str, heads: int) -> None:
    if mode not in MODES:
        raise ValueError(f"ablate_attention: mode {mode!r} is not one of {MODES}")
    s, c = qkv.shape[1], qkv.shape[2] // 3
    if not 0 < heads <= c // HEAD_DIM:
        raise ValueError(f"ablate_attention: {heads} heads of a width of {c}")
    if mode == "scores_only" and s < HEAD_DIM:
        raise ValueError(f"ablate_attention: scores_only writes {HEAD_DIM} keys' scores, got {s}")


def ablate_attention_plain(qkv: torch.Tensor, mode: str, heads: int) -> torch.Tensor:
    """The Pallas kernel's arithmetic in the dtype of qkv: qkv (B, S, 3C) ->
    (B, S, C), the columns past heads * 64 zero."""
    _check_case(qkv, mode, heads)
    dt = qkv.dtype
    b, s, c3 = qkv.shape
    c = c3 // 3
    n = heads * HEAD_DIM
    q, k, v = (split_heads(x, c // HEAD_DIM)[:, :heads] for x in qkv.split(c, dim=-1))
    if mode == "slice_only":
        o = (q + k) + v  # each sum rounded to the dtype, as the kernel adds
    else:
        sc = q.float() @ k.float().transpose(-1, -2)
        if mode == "scores_only":
            o = sc[..., :HEAD_DIM]
        elif mode == "no_softmax":
            o = (sc * 0.01).to(dt).float() @ v.float()
        else:
            sc = (sc * FULL_SCALE)[..., :VALID_KEYS]  # a masked key's exp is 0
            p = torch.exp(sc - sc.amax(-1, keepdim=True))
            den = p.sum(-1, keepdim=True) + 1e-30
            o = (p.to(dt).float() @ v.float()[:, :, :VALID_KEYS]) / den
    out = torch.zeros((b, s, c), device=qkv.device, dtype=dt)
    out[..., :n] = merge_heads(o.to(dt))
    return out


def ablate_attention(qkv: torch.Tensor, mode: str, heads: int) -> torch.Tensor:
    """One case of the ablation on qkv (B, S, 3C) -> (B, S, C): the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if qkv.device.type == "cpu":
        return ablate_attention_plain(qkv, mode, heads)
    _check_case(qkv, mode, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"ablate_attention: the kernel takes CUDA tensors, got {qkv.device}")
    b, s, c3 = qkv.shape
    c = c3 // 3
    kl = check_head_limits("ablate_attention", c, c // HEAD_DIM, s, qkv.dtype)
    expect(qkv, "qkv", (b, s, c3), torch.bfloat16, qkv.device)
    out = torch.zeros((b, s, c), device=qkv.device, dtype=qkv.dtype)
    if qkv.numel() == 0:
        return out
    with torch.cuda.device(qkv.device):
        err = kl.lib.demo2_attention_ablate(
            qkv.data_ptr(), out.data_ptr(), b, s, c, heads, MODES.index(mode),
            min(VALID_KEYS, s), torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, f"ablate_attention {mode}")
    ablate_attention.launches += 1
    return out


ablate_attention.launches = 0


def case_bytes(shape, heads: int) -> int:
    """The bytes a case must move: qkv read once, the written columns once."""
    b, s, c3 = shape
    return 2 * b * s * (c3 + heads * HEAD_DIM)


def time_cases(qkv: torch.Tensor, iters: int = 20, warmup: int = 3) -> dict:
    """(mode, heads) -> ms of one launch, by CUDA events over `iters`."""
    times = {}
    for mode, heads in CASES:
        for _ in range(warmup):
            ablate_attention(qkv, mode, heads)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            ablate_attention(qkv, mode, heads)
        end.record()
        torch.cuda.synchronize()
        times[(mode, heads)] = start.elapsed_time(end) / iters
    return times


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernel_ablate needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator().manual_seed(0)
    qkv = (torch.randn(SHAPE, generator=g) * 0.05).to("cuda", torch.bfloat16)
    for (mode, heads), ms in time_cases(qkv).items():
        bound = case_bytes(SHAPE, heads) / (HBM_PEAK_TBS * 1e9)
        print(f"{mode} h={heads}: {ms:.4f} ms/iter; bound {bound:.4f} ms by bytes "
              f"({100 * bound / ms:.1f}% of it reached) ({card})", flush=True)


if __name__ == "__main__":
    main()
