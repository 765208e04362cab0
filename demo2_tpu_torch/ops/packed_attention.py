"""Attention on the packed (B, S, 3C) qkv layout
(demo2_tpu/ops/packed_attention.py), and the one definition of the
saved-probs layout.

  packed_attention_fwd:   self-attention (B, S, 3C) -> (B, S, C)
      replaces the Pallas kernel packed_attention.py::_fwd_kernel
      (csrc/packed_attention.cu, demo2_packed_attention);
  packed_attention_bwd:   its backward, recomputing the probabilities
      replaces the Pallas kernel packed_attention.py::_bwd_kernel
      (csrc/packed_attention.cu, demo2_packed_attention_bwd);
      both keep scores and probabilities in registers, one warp per 16 rows
      of a (sample, head) (csrc/attention_regs_fwd.cuh, attention_regs_bwd.cuh),
      over heads of 64 and at most 144 tokens (the register tiles' limit; the
      wide forms below take up to 256);
  packed_attention_wide_fwd / _bwd: the same two functions over heads of 64
      or 96 and at most 256 tokens, where the two above send every shape they
      do not take (csrc/packed_attention_wide.cu, demo2_packed_attention_wide
      and _wide_bwd; vit_small's heads of 96, the 211 tokens of stride 12);
  attention_bwd_saved_db: dqkv and the f32 qkv-bias gradient from saved probs
      replaces the Pallas kernel packed_attention.py::_bwd_saved_db_kernel
      (csrc/attention_bwd.cu, demo2_attention_bwd_saved_db);
  attention_bwd_saved:    dqkv only
      replaces the Pallas kernel packed_attention.py::_bwd_saved_kernel
      (csrc/attention_bwd.cu, demo2_attention_bwd_saved);
      both on the same register-resident backward, reading the saved
      probabilities in place of recomputing them, over heads of 64 and at
      most 144 tokens;
  attention_bwd_saved_db_wide / attention_bwd_saved_wide: the same two over
      heads of 64 and at most 256 tokens, where the two above send the
      sequences past 144 (csrc/attention_bwd.cu, demo2_attention_bwd_saved_db_wide
      and _saved_wide, on csrc/attention_wide_block.cuh; the CLIP flagship at
      stride 12, 211 tokens);
  attention_bwd_fused_dw: the saved-probs backward with dqkv contracted at
      once into dt, the f32 dW_qkv and the f32 db_qkv
      replaces the Pallas kernel packed_attention.py::_bwd_fused_dw_kernel
      (csrc/attention_bwd.cu, demo2_attention_bwd_fused_dw): kernel 4's
      backward (either form, by S) into a bf16 dqkv scratch, then dt and dW
      on the wgmma GEMM of csrc/gemm_sm90.cuh.

`packed_self_attention` is the entry of the ImageNet ViT's blocks and of
MultiHeadAttention's packed route: with grad enabled and a qkv that requires
grad it runs PackedSelfAttentionFn, the custom VJP of
packed_attention.py::_packed (its only residual is qkv, as `_packed_fwd`
keeps it); otherwise the forward kernel alone, as JAX's primal-only call
does.

The probs layout, written by the training forward (ops/fused_block.py and
csrc/fused_attention_block.cu) and read by the saved-probs backward here and
in csrc/attention_regs_bwd.cuh: (B, H, S, S16) in the
compute dtype, S16 = S rounded up to 16, row (b, h, i) the normalised
probabilities of query i over the keys, zero in the columns >= S.  Unlike the TPU's head-concat layout it
depends on no block-size policy, so the forward and the backward cannot
disagree on it.

Each wrapper takes the plain version for tensors on the CPU and launches its
kernel for CUDA tensors (it raises on what the kernel does not take); each
counts its launches in `.launches`.
"""

from __future__ import annotations

import torch

from .. import not_ported
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


# The ROADMAP item (queue 2a, item 1) that an f32 model on the block kernels
# (1, 2, 3, 4, 7 and 8) waits for; kernels 5, 6, 9 and 10 wait for item 2.
BLOCK_DTYPE_ITEM = "f32 inputs in the block kernels 1, 2, 3, 4, 7 and 8"


def check_input_dtype(what: str, dtype: torch.dtype, item: str = BLOCK_DTYPE_ITEM) -> None:
    """Raise, naming the ROADMAP item, for an input dtype the CUDA kernels do
    not read: the Pallas kernels compute in the dtype of x, f32 included; the
    CUDA tiles read bf16."""
    if dtype != torch.bfloat16:
        raise not_ported(f"{what} on {dtype} inputs (the kernel takes torch.bfloat16)", item)


def check_head_limits(what: str, width: int, num_heads: int, seq: int,
                      dtype: torch.dtype = torch.bfloat16, wide: bool = False,
                      block: bool = False):
    """Raise for heads, sequences or input dtypes the attention tiles
    (kernels 1, 3-10) do not take; return the library.  The register tiles
    take heads of 64 over at most 144 tokens.  `wide`: the limits of kernels
    5 and 6, which also take the wide pair's shapes (heads of 64 or 96 over
    at most 256 tokens); `block`: those of the block kernels 1, 3, 4, 7 and
    8, whose wide forms take heads of 64 over at most 256 tokens.  The Pallas
    kernels take any head width and length, and f32 inputs too; the CUDA
    tiles read bf16."""
    item = "wider heads, longer sequences and f32 inputs in the attention kernels"
    check_input_dtype(what, dtype, item)
    kl = kernel_library()
    head_dim = width // num_heads
    if wide:
        takes = head_dim * num_heads == width and \
            kl.lib.demo2_packed_attention_wide_takes_head(head_dim)
        heads, max_seq = "64 or 96", kl.lib.demo2_packed_attention_wide_max_seq()
    else:
        heads = kl.lib.demo2_attention_head_dim()
        max_seq = (kl.lib.demo2_block_attention_max_seq() if block
                   else kl.lib.demo2_attention_max_seq())
        takes = width == num_heads * heads
    if not takes:
        raise not_ported(f"{what} with {num_heads} heads over width {width} (the kernel "
                         f"takes heads of {heads})", item)
    if seq > max_seq:
        raise not_ported(f"{what} over {seq} tokens (the kernel takes {max_seq})", item)
    return kl


def regs_take(kl, width: int, num_heads: int, seq: int) -> bool:
    """The register tiles take this shape: kernels 5 and 6's register pair
    (else the wide pair), and the register forms of kernels 1, 3, 4 and 7
    (else their wide forms)."""
    return (width == num_heads * kl.lib.demo2_attention_head_dim()
            and seq <= kl.lib.demo2_attention_max_seq())


def _expect_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {t.device}")


def _check_inputs(qkv, probs, do, num_heads, what):
    _expect_cuda(qkv, what)
    check_input_dtype(what, qkv.dtype)
    b, s, c3 = qkv.shape
    c = c3 // 3
    kl = check_head_limits(what, c, num_heads, s, block=True)
    for tensor, name, shape in ((qkv, "qkv", (b, s, c3)),
                                (probs, "probs", probs_shape(b, num_heads, s)),
                                (do, "do", (b, s, c))):
        expect(tensor, name, shape, torch.bfloat16, qkv.device)
    return kl, b, s, c


def _launch_saved_db(wrapper, entry, kl, qkv, probs, do, num_heads, scale):
    """Launch `entry` (kernel 4, either form) on checked inputs and count it
    on `wrapper`.  The (B, 3C) f32 partial sums of db, one row a sample, are
    scratch allocated here."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dqkv = torch.empty_like(qkv)
    db = torch.empty((3 * c,), device=qkv.device, dtype=torch.float32)
    partial = torch.empty((b, 3 * c), device=qkv.device, dtype=torch.float32)
    if qkv.numel() == 0:
        return dqkv, db.zero_()
    with torch.cuda.device(qkv.device):
        err = getattr(kl.lib, entry)(
            qkv.data_ptr(), probs.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
            partial.data_ptr(), db.data_ptr(), b, s, c, num_heads, float(scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, wrapper.__name__)
    wrapper.launches += 1
    return dqkv, db


def _launch_saved(wrapper, entry, kl, qkv, probs, do, num_heads, scale):
    """Launch `entry` (kernel 7, either form) on checked inputs and count it
    on `wrapper`."""
    b, s, c3 = qkv.shape
    dqkv = torch.empty_like(qkv)
    if qkv.numel() == 0:
        return dqkv
    with torch.cuda.device(qkv.device):
        err = getattr(kl.lib, entry)(
            qkv.data_ptr(), probs.data_ptr(), do.data_ptr(), dqkv.data_ptr(), b, s, c3 // 3,
            num_heads, float(scale), torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, wrapper.__name__)
    wrapper.launches += 1
    return dqkv


def attention_bwd_saved_db(qkv, probs, do, *, num_heads: int, scale: float):
    """(dqkv (B, S, 3C), db (3C,) f32): the kernel on CUDA tensors (its wide
    form past the register tiles' 144 tokens), the plain version on CPU
    tensors."""
    if qkv.device.type == "cpu":
        return attention_bwd_saved_plain(qkv, probs, do, num_heads=num_heads, scale=scale,
                                         with_db=True)
    kl, _, s, c = _check_inputs(qkv, probs, do, num_heads, "attention_bwd_saved_db")
    wrapper = attention_bwd_saved_db if regs_take(kl, c, num_heads, s) \
        else attention_bwd_saved_db_wide
    return _launch_saved_db(wrapper, f"demo2_{wrapper.__name__}", kl, qkv, probs, do,
                            num_heads, scale)


attention_bwd_saved_db.launches = 0


def attention_bwd_saved(qkv, probs, do, *, num_heads: int, scale: float):
    """dqkv (B, S, 3C): the kernel on CUDA tensors (its wide form past the
    register tiles' 144 tokens), the plain version on CPU tensors."""
    if qkv.device.type == "cpu":
        return attention_bwd_saved_plain(qkv, probs, do, num_heads=num_heads, scale=scale,
                                         with_db=False)
    kl, _, s, c = _check_inputs(qkv, probs, do, num_heads, "attention_bwd_saved")
    wrapper = attention_bwd_saved if regs_take(kl, c, num_heads, s) else attention_bwd_saved_wide
    return _launch_saved(wrapper, f"demo2_{wrapper.__name__}", kl, qkv, probs, do, num_heads,
                         scale)


attention_bwd_saved.launches = 0


def attention_bwd_saved_db_wide(qkv, probs, do, *, num_heads: int, scale: float):
    """attention_bwd_saved_db on its wide form: heads of 64, S <= 256; the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if qkv.device.type == "cpu":
        return attention_bwd_saved_plain(qkv, probs, do, num_heads=num_heads, scale=scale,
                                         with_db=True)
    kl = _check_inputs(qkv, probs, do, num_heads, "attention_bwd_saved_db_wide")[0]
    return _launch_saved_db(attention_bwd_saved_db_wide, "demo2_attention_bwd_saved_db_wide", kl,
                            qkv, probs, do, num_heads, scale)


attention_bwd_saved_db_wide.launches = 0


def attention_bwd_saved_wide(qkv, probs, do, *, num_heads: int, scale: float):
    """attention_bwd_saved on its wide form: heads of 64, S <= 256; the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if qkv.device.type == "cpu":
        return attention_bwd_saved_plain(qkv, probs, do, num_heads=num_heads, scale=scale,
                                         with_db=False)
    kl = _check_inputs(qkv, probs, do, num_heads, "attention_bwd_saved_wide")[0]
    return _launch_saved(attention_bwd_saved_wide, "demo2_attention_bwd_saved_wide", kl, qkv,
                         probs, do, num_heads, scale)


attention_bwd_saved_wide.launches = 0


def attention_bwd_fused_dw_plain(qkv, probs, do, t, wqkv, *, num_heads: int, scale: float):
    """_bwd_fused_dw_kernel's arithmetic in the dtype of qkv:
    attention_bwd_saved_plain's dqkv, rounded to that dtype, and only then
    contracted, each product accumulated in f32: dt = dqkv @ W over the whole
    3C, rounded once; dW = dqkv^T t and db = the column sums, returned in f32.
    t (B, S, C) is the qkv projection's input, wqkv (3C, C) its weight in
    torch's Linear layout -> (dt (B, S, C), dwqkv (3C, C) f32, dbqkv (3C,) f32)."""
    dt = qkv.dtype
    b, s, c3 = qkv.shape
    dqkv = attention_bwd_saved_plain(qkv, probs, do, num_heads=num_heads, scale=scale,
                                     with_db=False).reshape(-1, c3).float()
    dw = dqkv.t() @ t.reshape(-1, c3 // 3).float()
    return (dqkv @ wqkv.float()).to(dt).reshape(b, s, c3 // 3), dw, dqkv.sum(0)


# Rows of dqkv (the K of dW = dqkv^T t) in one slice of kernel 8's dW
# product: 36 K steps of 64 a work unit.  At 192 x 129 rows that is 11 slices,
# 11 x 72 output tiles = 792 units, six whole rounds of an H100's 132 SMs.
# The slices follow from the shape alone, so dW's bits do not depend on the card.
DW_SLICE_ROWS = 2304


def attention_bwd_fused_dw(qkv, probs, do, t, wqkv, *, num_heads: int, scale: float):
    """(dt (B, S, C), dwqkv (3C, C) f32, dbqkv (3C,) f32) as
    attention_bwd_fused_dw_plain returns them: the kernel on CUDA tensors, the
    plain version on CPU tensors.  The kernel's scratch is allocated here:
    dqkv (B*S, 3C) bf16, kernel 4's per-sample db partials (B, 3C) f32 and,
    where B*S > DW_SLICE_ROWS, the f32 dW partials of the row slices."""
    if qkv.device.type == "cpu":
        return attention_bwd_fused_dw_plain(qkv, probs, do, t, wqkv, num_heads=num_heads,
                                            scale=scale)
    kl, b, s, c = _check_inputs(qkv, probs, do, num_heads, "attention_bwd_fused_dw")
    dev, f32 = qkv.device, torch.float32
    expect(t, "t", (b, s, c), torch.bfloat16, dev)
    expect(wqkv, "wqkv", (3 * c, c), torch.bfloat16, dev)
    dt = torch.empty_like(t)
    dw = torch.empty((3 * c, c), device=dev, dtype=f32)
    db = torch.empty((3 * c,), device=dev, dtype=f32)
    if qkv.numel() == 0:
        return dt, dw.zero_(), db.zero_()
    slices = -(-(b * s) // DW_SLICE_ROWS)
    dqkv = torch.empty_like(qkv)
    db_partial = torch.empty((b, 3 * c), device=dev, dtype=f32)
    dw_partial = torch.empty((slices, 3 * c, c), device=dev, dtype=f32) if slices > 1 else dw
    with torch.cuda.device(dev):
        err = kl.lib.demo2_attention_bwd_fused_dw(
            qkv.data_ptr(), probs.data_ptr(), do.data_ptr(), t.data_ptr(), wqkv.data_ptr(),
            dt.data_ptr(), dw.data_ptr(), db.data_ptr(), dqkv.data_ptr(),
            db_partial.data_ptr(), dw_partial.data_ptr(), b, s, c, num_heads, DW_SLICE_ROWS,
            float(scale), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "attention_bwd_fused_dw")
    attention_bwd_fused_dw.launches += 1
    return dt, dw, db


attention_bwd_fused_dw.launches = 0


# ---------------------------------------------------------------------------
# Packed self-attention (kernel 5) and its recomputing backward (kernel 6).
# ---------------------------------------------------------------------------


def needs_grad(*tensors) -> bool:
    """Grad mode is on and some tensor requires grad: a call JAX would make
    under jax.grad, where the custom VJP's forward runs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _probs_f32(q, k, scale):
    """exp(s - rowmax) of the f32 scores s = (q @ k^T) * scale, and
    rowsum + 1e-30 (packed_attention.py::_unnorm_probs)."""
    sc = (q @ k.transpose(-1, -2)) * scale
    pu = torch.exp(sc - sc.amax(-1, keepdim=True))
    return pu, pu.sum(-1, keepdim=True) + 1e-30


def packed_self_attention_plain(qkv, num_heads: int, scale: float) -> torch.Tensor:
    """_fwd_kernel's arithmetic in the dtype of qkv: f32 scores, the
    unnormalised exp rounded to that dtype for the PV product (f32
    accumulation), the f32 result divided by rowsum + 1e-30.
    qkv (B, S, 3C) -> (B, S, C)."""
    dt = qkv.dtype
    c = qkv.shape[-1] // 3
    q, k, v = (split_heads(x, num_heads).float() for x in qkv.split(c, dim=-1))
    pu, denom = _probs_f32(q, k, scale)
    return merge_heads(((pu.to(dt).float() @ v) / denom).to(dt))


def packed_attention_bwd_plain(qkv, do, num_heads: int, scale: float) -> torch.Tensor:
    """_bwd_kernel's arithmetic in the dtype of qkv: p recomputed and
    normalised in f32; dV from p rounded to that dtype, dS from the f32 p,
    rounded before the dQ / dK products; dq, dk, dv rounded at the end.
    qkv (B, S, 3C), do (B, S, C) -> dqkv (B, S, 3C)."""
    dt = qkv.dtype
    c = qkv.shape[-1] // 3
    q, k, v = (split_heads(x, num_heads).float() for x in qkv.split(c, dim=-1))
    dof = split_heads(do, num_heads).float()
    pu, denom = _probs_f32(q, k, scale)
    p = pu / denom
    dv = (p.to(dt).float().transpose(-1, -2) @ dof).to(dt)
    dp = dof @ v.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = ((ds @ k) * scale).to(dt)
    dk = ((ds.transpose(-1, -2) @ q) * scale).to(dt)
    return torch.cat([merge_heads(dq), merge_heads(dk), merge_heads(dv)], dim=-1)


def _check_packed(qkv, num_heads, what, do=None):
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {qkv.device}")
    b, s, c3 = qkv.shape
    c = c3 // 3
    kl = check_head_limits(what, c, num_heads, s, qkv.dtype, wide=True)
    expect(qkv, "qkv", (b, s, c3), torch.bfloat16, qkv.device)
    if do is not None:
        expect(do, "do", (b, s, c), torch.bfloat16, qkv.device)
    return kl, b, s, c


def packed_attention_fwd(qkv, *, num_heads: int, scale: float) -> torch.Tensor:
    """(B, S, 3C) -> (B, S, C): the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if qkv.device.type == "cpu":
        return packed_self_attention_plain(qkv, num_heads, scale)
    kl, b, s, c = _check_packed(qkv, num_heads, "packed_attention_fwd")
    if not regs_take(kl, c, num_heads, s):
        return packed_attention_wide_fwd(qkv, num_heads=num_heads, scale=scale)
    out = torch.empty((b, s, c), device=qkv.device, dtype=qkv.dtype)
    if qkv.numel() == 0:
        return out
    with torch.cuda.device(qkv.device):
        err = kl.lib.demo2_packed_attention(
            qkv.data_ptr(), out.data_ptr(), b, s, c, num_heads, float(scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "packed_attention_fwd")
    packed_attention_fwd.launches += 1
    return out


packed_attention_fwd.launches = 0


def packed_attention_bwd(qkv, do, *, num_heads: int, scale: float) -> torch.Tensor:
    """dqkv (B, S, 3C) from qkv and the output cotangent do (B, S, C): the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if qkv.device.type == "cpu":
        return packed_attention_bwd_plain(qkv, do, num_heads, scale)
    kl, b, s, c = _check_packed(qkv, num_heads, "packed_attention_bwd", do)
    if not regs_take(kl, c, num_heads, s):
        return packed_attention_wide_bwd(qkv, do, num_heads=num_heads, scale=scale)
    dqkv = torch.empty_like(qkv)
    if qkv.numel() == 0:
        return dqkv
    with torch.cuda.device(qkv.device):
        err = kl.lib.demo2_packed_attention_bwd(
            qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), b, s, c, num_heads, float(scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "packed_attention_bwd")
    packed_attention_bwd.launches += 1
    return dqkv


packed_attention_bwd.launches = 0


def packed_attention_wide_fwd(qkv, *, num_heads: int, scale: float) -> torch.Tensor:
    """packed_attention_fwd on the wide pair: (B, S, 3C) -> (B, S, C), heads
    of 64 or 96, S <= 256; the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if qkv.device.type == "cpu":
        return packed_self_attention_plain(qkv, num_heads, scale)
    kl, b, s, c = _check_packed(qkv, num_heads, "packed_attention_wide_fwd")
    out = torch.empty((b, s, c), device=qkv.device, dtype=qkv.dtype)
    if qkv.numel() == 0:
        return out
    with torch.cuda.device(qkv.device):
        err = kl.lib.demo2_packed_attention_wide(
            qkv.data_ptr(), out.data_ptr(), b, s, c, num_heads, float(scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "packed_attention_wide_fwd")
    packed_attention_wide_fwd.launches += 1
    return out


packed_attention_wide_fwd.launches = 0


def packed_attention_wide_bwd(qkv, do, *, num_heads: int, scale: float) -> torch.Tensor:
    """packed_attention_bwd on the wide pair: dqkv (B, S, 3C), heads of 64 or
    96, S <= 256; the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if qkv.device.type == "cpu":
        return packed_attention_bwd_plain(qkv, do, num_heads, scale)
    kl, b, s, c = _check_packed(qkv, num_heads, "packed_attention_wide_bwd", do)
    dqkv = torch.empty_like(qkv)
    if qkv.numel() == 0:
        return dqkv
    with torch.cuda.device(qkv.device):
        err = kl.lib.demo2_packed_attention_wide_bwd(
            qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), b, s, c, num_heads, float(scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "packed_attention_wide_bwd")
    packed_attention_wide_bwd.launches += 1
    return dqkv


packed_attention_wide_bwd.launches = 0


class PackedSelfAttentionFn(torch.autograd.Function):
    """packed_attention.py::_packed with its custom VJP: the forward (kernel 5
    on CUDA) keeps qkv alone, the backward (kernel 6 on CUDA) recomputes the
    probabilities from it."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        qkv = qkv.contiguous()
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return packed_attention_fwd(qkv, num_heads=num_heads, scale=scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return (packed_attention_bwd(qkv, g.contiguous(), num_heads=ctx.num_heads,
                                     scale=ctx.scale), None, None)


def packed_self_attention(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Self-attention on packed (B, S, 3C) qkv -> (B, S, C), heads laid out as
    `reshape(B, S, H, D)` of each C slice: the Function where a gradient is
    to flow, else the forward kernel alone."""
    if needs_grad(qkv):
        return PackedSelfAttentionFn.apply(qkv, num_heads, scale)
    return packed_attention_fwd(qkv.contiguous(), num_heads=num_heads, scale=scale)
