"""Attention backward from saved probabilities, on the packed (B, S, 3C) qkv
layout (demo2_tpu/ops/packed_attention.py: _packed_bwd_saved_db and
_packed_bwd_saved), and the one definition of the saved-probs layout.

The probs layout, written by the training forward (ops/fused_block.py and
csrc/fused_attention_block.cu) and read by the backward here and in
csrc/attention_bwd.cu: (B, H, S, S16) in the compute dtype, S16 = S rounded up
to 16, row (b, h, i) the normalised probabilities of query i over the keys,
zero in the columns >= S.  Unlike the TPU's head-concat layout it depends on
no block-size policy, so the forward and the backward cannot disagree on it.

  attention_bwd_saved_db: dqkv and the f32 qkv-bias gradient
      replaces the Pallas kernel packed_attention.py::_bwd_saved_db_kernel
      (csrc/attention_bwd.cu, demo2_attention_bwd_saved_db);
  attention_bwd_saved:    dqkv only
      replaces the Pallas kernel packed_attention.py::_bwd_saved_kernel
      (csrc/attention_bwd.cu, demo2_attention_bwd_saved).

Each wrapper takes the plain version for tensors on the CPU and launches its
kernel for CUDA tensors (it raises on what the kernel does not take); each
counts its launches in `.launches`.
"""

from __future__ import annotations

import torch

from .kernel_lib import check, expect, kernel_library

PROBS_ALIGN = 16


def probs_cols(s: int) -> int:
    """S16: the key columns of a probs row, S rounded up to 16."""
    return -(-s // PROBS_ALIGN) * PROBS_ALIGN


def probs_shape(b: int, num_heads: int, s: int) -> tuple:
    return (b, num_heads, s, probs_cols(s))


def split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, C) -> (B, H, S, D)."""
    b, s, c = t.shape
    return t.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def attention_bwd_saved_plain(qkv, probs, do, *, num_heads: int, scale: float,
                              with_db: bool):
    """_bwd_saved(_db)_kernel's arithmetic in the dtype of qkv: products in
    f32 on operands of that dtype, rounded to it where the Pallas kernel
    rounds (dS before the dQ / dK products; dq, dk, dv at the end).
    qkv (B, S, 3C), probs (B, H, S, S16), do (B, S, C) -> dqkv (B, S, 3C)
    [and db (3C,) f32, the column sums of the rounded dqkv]."""
    dt = qkv.dtype
    s, c = qkv.shape[1], qkv.shape[2] // 3
    q, k, v = (split_heads(x, num_heads).float() for x in qkv.split(c, dim=-1))
    dof = split_heads(do, num_heads).float()
    p = probs[..., :s].float()  # the columns >= S are zero
    dv = (p.transpose(-1, -2) @ dof).to(dt)
    dp = dof @ v.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = ((ds @ k) * scale).to(dt)
    dk = ((ds.transpose(-1, -2) @ q) * scale).to(dt)
    dqkv = torch.cat([merge_heads(dq), merge_heads(dk), merge_heads(dv)], dim=-1)
    if not with_db:
        return dqkv
    return dqkv, dqkv.float().sum((0, 1))


def _check_inputs(qkv, probs, do, num_heads, what):
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {qkv.device}")
    b, s, c3 = qkv.shape
    c = c3 // 3
    kl = kernel_library()
    head_dim, max_seq = kl.lib.demo2_attention_bwd_head_dim(), kl.lib.demo2_attention_bwd_max_seq()
    if c != num_heads * head_dim:
        raise ValueError(f"{what}: the kernel takes heads of {head_dim}, got width {c} / "
                         f"{num_heads} heads")
    if s > max_seq:
        raise ValueError(f"{what}: sequence {s} exceeds the kernel's {max_seq}")
    for tensor, name, shape in ((qkv, "qkv", (b, s, c3)),
                                (probs, "probs", probs_shape(b, num_heads, s)),
                                (do, "do", (b, s, c))):
        expect(tensor, name, shape, torch.bfloat16, qkv.device)
    return kl, b, s, c


def attention_bwd_saved_db(qkv, probs, do, *, num_heads: int, scale: float):
    """(dqkv (B, S, 3C), db (3C,) f32): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if qkv.device.type == "cpu":
        return attention_bwd_saved_plain(qkv, probs, do, num_heads=num_heads, scale=scale,
                                         with_db=True)
    kl, b, s, c = _check_inputs(qkv, probs, do, num_heads, "attention_bwd_saved_db")
    dqkv = torch.empty_like(qkv)
    db = torch.empty((3 * c,), device=qkv.device, dtype=torch.float32)
    partial = torch.empty((b, 3 * c), device=qkv.device, dtype=torch.float32)
    if qkv.numel() == 0:
        return dqkv, db.zero_()
    with torch.cuda.device(qkv.device):
        err = kl.lib.demo2_attention_bwd_saved_db(
            qkv.data_ptr(), probs.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
            partial.data_ptr(), db.data_ptr(), b, s, c, num_heads, float(scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "attention_bwd_saved_db")
    attention_bwd_saved_db.launches += 1
    return dqkv, db


attention_bwd_saved_db.launches = 0


def attention_bwd_saved(qkv, probs, do, *, num_heads: int, scale: float):
    """dqkv (B, S, 3C): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if qkv.device.type == "cpu":
        return attention_bwd_saved_plain(qkv, probs, do, num_heads=num_heads, scale=scale,
                                         with_db=False)
    kl, b, s, c = _check_inputs(qkv, probs, do, num_heads, "attention_bwd_saved")
    dqkv = torch.empty_like(qkv)
    if qkv.numel() == 0:
        return dqkv
    with torch.cuda.device(qkv.device):
        err = kl.lib.demo2_attention_bwd_saved(
            qkv.data_ptr(), probs.data_ptr(), do.data_ptr(), dqkv.data_ptr(), b, s, c,
            num_heads, float(scale), torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "attention_bwd_saved")
    attention_bwd_saved.launches += 1
    return dqkv


attention_bwd_saved.launches = 0
