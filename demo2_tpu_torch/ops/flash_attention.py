"""Head-major attention with a recomputing backward
(demo2_tpu/ops/flash_attention.py), on (B, S, H, D) tensors.

  flash_attention_fwd: softmax(q k^T * scale) v, f32 inside
      replaces the Pallas kernel flash_attention.py::_fwd_kernel
      (csrc/flash_attention.cu, demo2_flash_attention);
  flash_attention_bwd: (dq, dk, dv), the probabilities recomputed
      replaces the Pallas kernel flash_attention.py::_bwd_kernel
      (csrc/flash_attention.cu, demo2_flash_attention_bwd).
Both keep scores and probabilities in registers, one warp per 16 rows of a
(sample, head) (csrc/attention_regs_fwd.cuh, attention_regs_bwd.cuh).

`flash_attention` is attention_core's route for implementation="pallas"
(ops/attention.py): with grad enabled and an input that requires grad it
runs FlashAttentionFn, the custom VJP of flash_attention.py::_flash (its
residuals are q, k and v); otherwise the forward kernel alone.

The plain versions follow the TPU kernels, which cast q, k and v to f32 and
keep everything in f32 (p too, for the PV product); only the outputs are
rounded.  JAX's own off-TPU fallback rounds p to the value dtype instead;
the port follows the kernel.  The CUDA kernels read the (B, S, H, D)
strides directly where the JAX wrapper copies to (B, H, S, D) and back.

Each wrapper takes the plain version for tensors on the CPU and launches its
kernel for CUDA tensors (it raises on what the kernel does not take); each
counts its launches in `.launches`.
"""

from __future__ import annotations

import torch

from .kernel_lib import check, expect
from .packed_attention import check_head_limits, needs_grad


def _probs(q, k, scale):
    """flash_attention.py::_softmax_probs per head, in f32: q, k (B, H, S, D)
    f32 -> p (B, H, S, S)."""
    s = (q * scale) @ k.transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / (p.sum(-1, keepdim=True) + 1e-30)


def _heads_f32(*xs):
    """(B, S, H, D) -> (B, H, S, D) in f32."""
    return (x.float().transpose(1, 2) for x in xs)


def flash_attention_plain(q, k, v, *, scale: float) -> torch.Tensor:
    """_fwd_kernel's arithmetic: all f32, the output in the dtype of q."""
    qf, kf, vf = _heads_f32(q, k, v)
    return (_probs(qf, kf, scale) @ vf).transpose(1, 2).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, do, *, scale: float):
    """_bwd_kernel's arithmetic: all f32, (dq, dk, dv) in the dtype of q."""
    qf, kf, vf, dof = _heads_f32(q, k, v, do)
    p = _probs(qf, kf, scale)
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    return tuple(x.transpose(1, 2).to(q.dtype) for x in (dq, dk, dv))


def _check(what, *tensors):
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {q.device}")
    b, s, h, d = q.shape
    kl = check_head_limits(what, h * d, h, s, q.dtype)
    for name, x in zip(("q", "k", "v", "do"), tensors):
        expect(x, name, (b, s, h, d), torch.bfloat16, q.device)
    return kl, b, s, h


def flash_attention_fwd(q, k, v, *, scale: float) -> torch.Tensor:
    """q, k, v (B, S, H, D) -> (B, S, H, D): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale)
    kl, b, s, h = _check("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = kl.lib.demo2_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, do, *, scale: float):
    """(dq, dk, dv), each (B, S, H, D): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, scale=scale)
    kl, b, s, h = _check("flash_attention_bwd", q, k, v, do)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        err = kl.lib.demo2_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, h, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """flash_attention.py::_flash with its custom VJP: the forward (kernel 9
    on CUDA) keeps q, k and v, the backward (kernel 10 on CUDA) recomputes
    the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return flash_attention_fwd(q, k, v, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, g.contiguous(), scale=ctx.scale), None)


def flash_attention(q, k, v, *, scale: float) -> torch.Tensor:
    """Attention on (B, S, H, D) q, k, v of one sequence length: the Function
    where a gradient is to flow, else the forward kernel alone."""
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, scale)
    return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)
