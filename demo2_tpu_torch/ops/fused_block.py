"""The CLIP ViT block's fused sub-blocks, each a CUDA kernel with its plain
PyTorch version (demo2_tpu/ops/fused_block.py).

  fused_attention_block:       x + out_proj(MHA(LN1(x))) at eval
      replaces the Pallas kernel fused_block.py::_fwd_kernel_infer
      (csrc/fused_attention_block.cu, demo2_fused_attention_block);
  fused_attention_block_train: the same, plus the residuals qkv, attn and
      the bf16 probs (ops/packed_attention.py's layout) for the backward
      replaces the Pallas kernel fused_block.py::_fwd_kernel
      (csrc/fused_attention_block.cu, demo2_fused_attention_block_train);
      both take heads of 64 over at most 144 tokens (the register tiles);
  fused_attention_block_wide / fused_attention_block_train_wide: the same
      two with their attention on csrc/attention_wide_block.cuh, heads of 64
      over at most 256 tokens, where the two above send the sequences past
      144 (demo2_fused_attention_block_wide and _train_wide; the CLIP
      flagship at MODEL.STRIDE_SIZE (12, 12), 211 tokens at 256x128);
  fused_attention_block_long / fused_attention_block_train_long: the same
      two with their attention on csrc/attention_long_block.cuh, heads of 64
      over 257-512 tokens, where the two above send the sequences past 256
      (demo2_fused_attention_block_long and _train_long; the flagship on
      TransReID's stride-12 crops, 311 tokens at 384x128, 442 at 256x256);
  fused_mlp_block:             x + fc2(QuickGELU(fc1(LN2(x)))) at eval
      replaces the Pallas kernel fused_block.py::_mlp_kernel
      (csrc/fused_mlp_block.cu, demo2_fused_mlp_block);
  fused_mlp_block_train:       the same, plus the pre-GELU hidden h that the
      Pallas kernel writes for its backward
      (csrc/fused_mlp_block.cu, demo2_fused_mlp_block_train).

`fused_attention` is the attention sub-block's entry: with grad enabled and an
input that requires grad it runs FusedAttentionBlockFn, the custom VJP of
fused_block.py::_fused (training forward, then _fused_bwd's chain around the
saved-probs attention backward of ops/packed_attention.py); otherwise the
eval kernel, as JAX's primal-only call does.  `attention_block_backward` is
that chain; with `fused_dw=True` its middle is the fused-dW backward (kernel
8), which keeps dqkv on chip, instead of kernel 4 and the two products around
it: the variant JAX keeps beside `_fused_bwd` and reaches only from its
tests.  No configuration selects it here either.  `fused_mlp` is the MLP
sub-block's entry in the same way, around FusedMlpBlockFn, the custom VJP of
fused_block.py::_fused_mlp.

Each wrapper takes the plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor; there is no fallback between the two: on a
CUDA tensor a missing nvcc, a failed build or a refused launch raises.  Each
wrapper counts its kernel launches in `.launches`.

Weights are in torch's Linear layout (out, in): wqkv (3C, C), wout (C, C),
w1 (4C, C), w2 (C, 4C).  The kernels take x and the weights in bf16 and the
LayerNorm and bias vectors in f32 (the dtypes the Pallas kernels are fed);
callers pass cached casts (ops/linear.py::cached_cast).  FusedAttentionBlockFn
takes the f32 parameters, casts them once per call and returns f32 grads, as
JAX's custom VJP does.
"""

from __future__ import annotations

import torch

from .activations import quick_gelu
from .attention import attention_core
from .kernel_lib import check, expect, kernel_library
from .packed_attention import (attention_bwd_fused_dw, attention_bwd_saved,
                               attention_bwd_saved_db, check_head_limits, check_input_dtype,
                               block_form, merge_heads, needs_grad, probs_cols, probs_shape,
                               split_heads)


def _layernorm_f32(x, weight, bias, eps=1e-5):
    """fused_block.py::_layernorm_f32: the whole LayerNorm in f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)) * weight.float() + bias.float()


def _self_attention(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Self-attention on packed (B, S, 3C) qkv -> (B, S, C), the attention
    of fused_block.py::_reference_impl (p rounded after normalising)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    q, k, v = (t.reshape(b, s, num_heads, c // num_heads) for t in qkv.split(c, dim=-1))
    return attention_core(q, k, v, scale=scale).reshape(b, s, c)


def attention_block_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                          num_heads: int, scale: float) -> torch.Tensor:
    """fused_block.py::_reference_impl in the dtype of x."""
    dt = x.dtype
    t = _layernorm_f32(x, ln_weight, ln_bias).to(dt)
    qkv = t @ wqkv.to(dt).t() + bqkv.to(dt)
    o = _self_attention(qkv, num_heads, scale)
    return x + o @ wout.to(dt).t() + bout.to(dt)


def mlp_block_plain(x, ln_weight, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """fused_block.py::_mlp_reference_impl in the dtype of x."""
    dt = x.dtype
    t = _layernorm_f32(x, ln_weight, ln_bias).to(dt)
    h = t @ w1.to(dt).t() + b1.to(dt)
    g = quick_gelu(h).to(dt)
    return x + g @ w2.to(dt).t() + b2.to(dt)


def _expect_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {x.device}")
    if x.shape[-1] % 8:
        raise ValueError(f"{what}: width {x.shape[-1]} is not a multiple of 8")


def _check_attention_inputs(what, x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, num_heads):
    """Raise on what the attention kernels do not take; return the library."""
    _expect_cuda(x, what)
    check_input_dtype(what, x.dtype)
    b, s, c = x.shape
    kl = check_head_limits(what, c, num_heads, s, block=True)
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    for tensor, name, shape, dtype in (
        (x, "x", (b, s, c), bf16), (ln_weight, "ln_weight", (c,), f32),
        (ln_bias, "ln_bias", (c,), f32), (wqkv, "wqkv", (3 * c, c), bf16),
        (bqkv, "bqkv", (3 * c,), f32), (wout, "wout", (c, c), bf16), (bout, "bout", (c,), f32),
    ):
        expect(tensor, name, shape, dtype, dev)
    return kl


def _launch_attention(wrapper, entry, kl, x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                      num_heads, scale, train: bool):
    """Launch `entry` (kernel 1 or 3, any form) on checked inputs and
    count it on `wrapper`: out at eval, (out, qkv, attn, probs) in
    training."""
    what = wrapper.__name__
    b, s, c = x.shape
    dev, bf16 = x.device, torch.bfloat16
    out = torch.empty_like(x)
    qkv = torch.empty((b, s, 3 * c), device=dev, dtype=bf16)
    attn = torch.empty((b, s, c), device=dev, dtype=bf16)
    probs = torch.empty(probs_shape(b, num_heads, s), device=dev, dtype=bf16) if train else None
    result = (out, qkv, attn, probs) if train else out
    if x.numel() == 0:
        return result
    t = torch.empty((b * s, c), device=dev, dtype=bf16)
    head = (x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(), out.data_ptr(), t.data_ptr(),
            qkv.data_ptr(), attn.data_ptr())
    with torch.cuda.device(dev):
        err = getattr(kl.lib, entry)(*head, *((probs.data_ptr(),) if train else ()), b, s, c,
                                     num_heads, float(scale),
                                     torch.cuda.current_stream(dev).cuda_stream)
    check(err, what)
    wrapper.launches += 1
    return result


def fused_attention_block(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                          num_heads: int, scale: float) -> torch.Tensor:
    """x (B, S, C) -> x + out_proj(MHA(LN(x))): the kernel on CUDA tensors
    (its wide form past the register tiles' 144 tokens, its long form past
    256), the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return attention_block_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                     num_heads=num_heads, scale=scale)
    args = (x, ln_weight, ln_bias, wqkv, bqkv, wout, bout)
    kl = _check_attention_inputs("fused_attention_block", *args, num_heads)
    wrapper = {"": fused_attention_block, "_wide": fused_attention_block_wide,
               "_long": fused_attention_block_long}[block_form(kl, x.shape[-1], num_heads,
                                                               x.shape[1])]
    return _launch_attention(wrapper, f"demo2_{wrapper.__name__}", kl, *args, num_heads, scale,
                             train=False)


fused_attention_block.launches = 0


def fused_attention_block_wide(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                               num_heads: int, scale: float) -> torch.Tensor:
    """fused_attention_block on its wide form: heads of 64, S <= 256; the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return attention_block_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                     num_heads=num_heads, scale=scale)
    args = (x, ln_weight, ln_bias, wqkv, bqkv, wout, bout)
    kl = _check_attention_inputs("fused_attention_block_wide", *args, num_heads)
    return _launch_attention(fused_attention_block_wide, "demo2_fused_attention_block_wide", kl,
                             *args, num_heads, scale, train=False)


fused_attention_block_wide.launches = 0


def fused_attention_block_long(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                               num_heads: int, scale: float) -> torch.Tensor:
    """fused_attention_block on its long form: heads of 64, 256 < S <= 512;
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return attention_block_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                     num_heads=num_heads, scale=scale)
    args = (x, ln_weight, ln_bias, wqkv, bqkv, wout, bout)
    kl = _check_attention_inputs("fused_attention_block_long", *args, num_heads)
    return _launch_attention(fused_attention_block_long, "demo2_fused_attention_block_long", kl,
                             *args, num_heads, scale, train=False)


fused_attention_block_long.launches = 0


def _launch_mlp(wrapper, x, ln_weight, ln_bias, w1, b1, w2, b2, with_hidden: bool):
    """Check what the MLP kernels take and launch the eval or the training
    entry for `wrapper`, whose launch it counts; returns (out, h (rows, F) or
    None)."""
    what = wrapper.__name__
    _expect_cuda(x, what)
    check_input_dtype(what, x.dtype)
    c = x.shape[-1]
    f = w1.shape[0]
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    if f % 8:
        raise ValueError(f"{what}: hidden width {f} is not a multiple of 8")
    for tensor, name, shape, dtype in (
        (x, "x", x.shape, bf16), (ln_weight, "ln_weight", (c,), f32),
        (ln_bias, "ln_bias", (c,), f32), (w1, "w1", (f, c), bf16), (b1, "b1", (f,), f32),
        (w2, "w2", (c, f), bf16), (b2, "b2", (c,), f32),
    ):
        expect(tensor, name, shape, dtype, dev)
    kl = kernel_library()
    out = torch.empty_like(x)
    rows = x.numel() // c
    h = torch.empty((rows, f), device=dev, dtype=bf16) if with_hidden else None
    if rows == 0:
        return out, h
    t = torch.empty((rows, c), device=dev, dtype=bf16)
    g = torch.empty((rows, f), device=dev, dtype=bf16)
    args = (x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), t.data_ptr(),
            g.data_ptr())
    tail = (rows, c, f, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if with_hidden:
            err = kl.lib.demo2_fused_mlp_block_train(*args, h.data_ptr(), *tail)
        else:
            err = kl.lib.demo2_fused_mlp_block(*args, *tail)
    check(err, what)
    wrapper.launches += 1
    return out, h


def fused_mlp_block(x, ln_weight, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """x (..., C) -> x + fc2(QuickGELU(fc1(LN(x)))): the kernel on CUDA
    tensors, the plain version on CPU tensors.  The eval form: the pre-GELU
    hidden, which only the backward reads, is fused_mlp_block_train's."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_weight, ln_bias, w1, b1, w2, b2)
    return _launch_mlp(fused_mlp_block, x, ln_weight, ln_bias, w1, b1, w2, b2,
                       with_hidden=False)[0]


fused_mlp_block.launches = 0


# ---------------------------------------------------------------------------
# Training: the forward with residuals (kernel 3) and the custom VJP.
# ---------------------------------------------------------------------------


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in f32 (preferred_element_type=f32):
    a bf16 GEMM with f32 output on a CUDA device, f32 operands elsewhere."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def attention_block_train_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                                num_heads: int, scale: float):
    """fused_block.py::_fwd_kernel's arithmetic in the dtype of x: products
    in f32 on operands of that dtype, f32 bias and softmax (+1e-30 in the
    denominator), rounded to it where the kernel rounds.  Returns (out,
    qkv (B, S, 3C), attn (B, S, C), probs (B, H, S, S16))."""
    dt = x.dtype
    b, s, c = x.shape
    t = _layernorm_f32(x, ln_weight, ln_bias).to(dt).reshape(-1, c)
    qkv = (_mm_f32(t, wqkv.to(dt).t()) + bqkv.float()).to(dt).reshape(b, s, 3 * c)
    q, k, v = (split_heads(y, num_heads).float() for y in qkv.split(c, dim=-1))
    sc = (q @ k.transpose(-1, -2)) * scale
    pu = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = (pu / (pu.sum(-1, keepdim=True) + 1e-30)).to(dt)
    attn = merge_heads((p.float() @ v).to(dt))
    y = (_mm_f32(attn.reshape(-1, c), wout.to(dt).t()) + bout.float()).to(dt)
    out = x + y.reshape(b, s, c)
    probs = torch.nn.functional.pad(p, (0, probs_cols(s) - s))
    return out, qkv, attn, probs


def fused_attention_block_train(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                                num_heads: int, scale: float):
    """The training forward: (out, qkv, attn, probs) as
    attention_block_train_plain returns them; the kernel on CUDA tensors (its
    wide form past the register tiles' 144 tokens, its long form past 256),
    the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return attention_block_train_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                           num_heads=num_heads, scale=scale)
    args = (x, ln_weight, ln_bias, wqkv, bqkv, wout, bout)
    kl = _check_attention_inputs("fused_attention_block_train", *args, num_heads)
    wrapper = {"": fused_attention_block_train, "_wide": fused_attention_block_train_wide,
               "_long": fused_attention_block_train_long}[block_form(kl, x.shape[-1],
                                                                     num_heads, x.shape[1])]
    return _launch_attention(wrapper, f"demo2_{wrapper.__name__}", kl, *args, num_heads, scale,
                             train=True)


fused_attention_block_train.launches = 0


def fused_attention_block_train_wide(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                                     num_heads: int, scale: float):
    """fused_attention_block_train on its wide form: heads of 64, S <= 256;
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return attention_block_train_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                           num_heads=num_heads, scale=scale)
    args = (x, ln_weight, ln_bias, wqkv, bqkv, wout, bout)
    kl = _check_attention_inputs("fused_attention_block_train_wide", *args, num_heads)
    return _launch_attention(fused_attention_block_train_wide,
                             "demo2_fused_attention_block_train_wide", kl, *args, num_heads,
                             scale, train=True)


fused_attention_block_train_wide.launches = 0


def fused_attention_block_train_long(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                                     num_heads: int, scale: float):
    """fused_attention_block_train on its long form: heads of 64, 256 < S <=
    512; the kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return attention_block_train_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                           num_heads=num_heads, scale=scale)
    args = (x, ln_weight, ln_bias, wqkv, bqkv, wout, bout)
    kl = _check_attention_inputs("fused_attention_block_train_long", *args, num_heads)
    return _launch_attention(fused_attention_block_train_long,
                             "demo2_fused_attention_block_train_long", kl, *args, num_heads,
                             scale, train=True)


fused_attention_block_train_long.launches = 0


class FusedAttentionBlockFn(torch.autograd.Function):
    """fused_block.py::_fused with its custom VJP: the forward saves qkv, attn
    and probs (kernel 3 on CUDA), the backward is _fused_bwd's chain with
    the saved-probs attention backward (kernel 4 on CUDA) in its middle.
    Takes the f32 parameters and returns f32 grads for them.  Only the grads
    the inputs need are computed: with the qkv bias frozen (an input-only
    gradient, as a saliency map takes it) the backward is kernel 7, without
    db.  JAX's custom VJP computes every cotangent regardless."""

    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, num_heads, scale):
        dt = x.dtype
        wqkv_c, wout_c = wqkv.to(dt).contiguous(), wout.to(dt).contiguous()
        lnw, lnb, bq, bo = (v.float().contiguous() for v in (ln_weight, ln_bias, bqkv, bout))
        out, qkv, attn, probs = fused_attention_block_train(
            x.contiguous(), lnw, lnb, wqkv_c, bq, wout_c, bo, num_heads=num_heads, scale=scale)
        ctx.save_for_backward(x, qkv, attn, probs, lnw, lnb, wqkv_c, wout_c)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        grads = attention_block_backward(*ctx.saved_tensors, g, num_heads=ctx.num_heads,
                                         scale=ctx.scale, needs=ctx.needs_input_grad[:7])
        return (*grads, None, None)


def _layernorm_recompute(x: torch.Tensor):
    """(xhat (M, C), rstd (M, 1)) of the rows of x, in f32."""
    xf = x.float().reshape(-1, x.shape[-1])
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + 1e-5)
    return (xf - mean) * rstd, rstd


def _layernorm_backward(dt, xhat, rstd, lnw, g, needs):
    """The f32 LayerNorm backward that closes both sub-blocks' chains: dt
    (M, C) the cotangent of LN(x), g the block's output cotangent (the
    residual's share of dx).  Returns (dx, dscale, dbias), None where
    `needs` (x, scale, bias) says so."""
    need_x, need_scale, need_bias = needs
    dtf = dt.float()
    dscale = (dtf * xhat).sum(0) if need_scale else None
    dbias = dtf.sum(0) if need_bias else None
    dx = None
    if need_x:
        dxhat = dtf * lnw
        dx_ln = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                        - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        dx = g + dx_ln.reshape(g.shape).to(g.dtype)
    return dx, dscale, dbias


def attention_block_backward(x, qkv, attn, probs, lnw, lnb, wqkv_c, wout_c, g, *,
                             num_heads: int, scale: float, needs=(True,) * 7,
                             fused_dw: bool = False):
    """fused_block.py::_fused_bwd's chain from the training forward's
    residuals and the output cotangent g: (dx, dscale, dbias, dwqkv, dbqkv,
    dwout, dbout), f32 for the parameters, None where `needs` says so.

    Its middle is the saved-probs attention backward, then dt = dqkv W and
    dW_qkv = dqkv^T t as two products (kernel 4 on CUDA; kernel 7 where db
    is not needed).  With `fused_dw` it is the fused-dW backward instead
    (kernel 8 on CUDA: kernel 4's backward, then dt and dW_qkv on its own
    GEMM, no torch product), which always computes all three."""
    need_x, need_lnw, need_lnb, need_wqkv, need_bqkv, need_wout, need_bout = needs
    b, s, c = x.shape
    g = g.contiguous()
    gm = g.reshape(-1, c)
    # residual + out-projection
    do = (gm @ wout_c).reshape(b, s, c)
    dwout = _mm_f32(gm.t(), attn.reshape(-1, c)) if need_wout else None
    dbout = gm.float().sum(0) if need_bout else None
    # t recomputed from x (fused_block.py:292-299)
    xhat, rstd = _layernorm_recompute(x)
    t = (xhat * lnw + lnb).to(x.dtype) if fused_dw or need_wqkv else None
    kw = dict(num_heads=num_heads, scale=scale)
    if fused_dw:
        dt, dwqkv, dbqkv = attention_bwd_fused_dw(qkv, probs, do, t.reshape(b, s, c), wqkv_c,
                                                  **kw)
        dt = dt.reshape(-1, c)
        dwqkv = dwqkv if need_wqkv else None
        dbqkv = dbqkv if need_bqkv else None
    else:
        # attention core from the saved probs; db_qkv only where it is wanted
        if need_bqkv:
            dqkv, dbqkv = attention_bwd_saved_db(qkv, probs, do, **kw)
        else:
            dqkv, dbqkv = attention_bwd_saved(qkv, probs, do, **kw), None
        dqkv_m = dqkv.reshape(-1, 3 * c)
        dt = dqkv_m @ wqkv_c
        dwqkv = _mm_f32(dqkv_m.t(), t) if need_wqkv else None
    dx, dscale, dbias = _layernorm_backward(dt, xhat, rstd, lnw, g,
                                            (need_x, need_lnw, need_lnb))
    return dx, dscale, dbias, dwqkv, dbqkv, dwout, dbout


def fused_attention(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *, num_heads: int,
                    scale: float) -> torch.Tensor:
    """x + out_proj(MHA(LN(x))) from the stored parameters: the training
    Function (kernels 3 and 4 on CUDA) where a gradient is to flow, else the
    eval kernel on weights cast to the dtype of x."""
    if needs_grad(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout):
        return FusedAttentionBlockFn.apply(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                           num_heads, scale)
    return fused_attention_block(x, ln_weight, ln_bias, wqkv.to(x.dtype), bqkv,
                                 wout.to(x.dtype), bout, num_heads=num_heads, scale=scale)


# ---------------------------------------------------------------------------
# The MLP in training: the forward with the hidden (kernel 2's training form)
# and the custom VJP.
# ---------------------------------------------------------------------------


def mlp_block_train_plain(x, ln_weight, ln_bias, w1, b1, w2, b2):
    """fused_block.py::_mlp_kernel's arithmetic in the dtype of x: products
    in f32 on operands of that dtype, f32 biases; h rounded to it from the
    f32 product + bias, g taken from the f32 h, the residual added in f32.
    Returns (out, h (M, F)), M the rows of x."""
    dt = x.dtype
    c = x.shape[-1]
    t = _layernorm_f32(x, ln_weight, ln_bias).to(dt).reshape(-1, c)
    hf = _mm_f32(t, w1.to(dt).t()) + b1.float()
    g = (hf * torch.sigmoid(1.702 * hf)).to(dt)
    y = _mm_f32(g, w2.to(dt).t()) + b2.float()
    return (x.float() + y.reshape(x.shape)).to(dt), hf.to(dt)


def fused_mlp_block_train(x, ln_weight, ln_bias, w1, b1, w2, b2):
    """The training forward: (out, h) as mlp_block_train_plain returns them;
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return mlp_block_train_plain(x, ln_weight, ln_bias, w1, b1, w2, b2)
    return _launch_mlp(fused_mlp_block_train, x, ln_weight, ln_bias, w1, b1, w2, b2,
                       with_hidden=True)


fused_mlp_block_train.launches = 0


class FusedMlpBlockFn(torch.autograd.Function):
    """fused_block.py::_fused_mlp with its custom VJP: the forward (kernel 2's
    training form on CUDA) saves the pre-GELU hidden h, the only residual
    beyond x; the backward is _fused_mlp_bwd's chain.  The GELU and its
    derivative are recomputed in f32 from the saved h, which is in the
    compute dtype, dh is rounded to it, t is recomputed from x.  The chain's
    four products and elementwise passes lie outside any Pallas kernel in
    JAX, so here they are torch.mm and tensor ops.  Takes the f32 parameters
    and returns f32 grads for them, and only the grads the inputs need."""

    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, w1, b1, w2, b2):
        dt = x.dtype
        w1_c, w2_c = w1.to(dt).contiguous(), w2.to(dt).contiguous()
        lnw, lnb, b1f, b2f = (v.float().contiguous() for v in (ln_weight, ln_bias, b1, b2))
        out, h = fused_mlp_block_train(x.contiguous(), lnw, lnb, w1_c, b1f, w2_c, b2f)
        ctx.save_for_backward(x, h, lnw, lnb, w1_c, w2_c)
        return out

    @staticmethod
    def backward(ctx, g):
        x, h, lnw, lnb, w1_c, w2_c = ctx.saved_tensors
        need_x, need_lnw, need_lnb, need_w1, need_b1, need_w2, need_b2 = ctx.needs_input_grad
        c = x.shape[-1]
        g = g.contiguous()
        dy = g.reshape(-1, c)
        hf = h.float()
        sig = torch.sigmoid(1.702 * hf)
        # fc2 backward
        dw2 = _mm_f32(dy.t(), (hf * sig).to(x.dtype)) if need_w2 else None
        db2 = dy.float().sum(0) if need_b2 else None
        dx = dscale = dbias = dw1 = db1 = None
        if need_x or need_lnw or need_lnb or need_w1 or need_b1:
            # GELU backward
            dg = (dy @ w2_c).float()
            dh = (dg * (sig * (1.0 + 1.702 * hf * (1.0 - sig)))).to(x.dtype)
            db1 = dh.float().sum(0) if need_b1 else None
            # fc1 backward, t recomputed from x
            xhat, rstd = _layernorm_recompute(x)
            dw1 = _mm_f32(dh.t(), (xhat * lnw + lnb).to(x.dtype)) if need_w1 else None
            if need_x or need_lnw or need_lnb:
                dx, dscale, dbias = _layernorm_backward(dh @ w1_c, xhat, rstd, lnw, g,
                                                        (need_x, need_lnw, need_lnb))
        return dx, dscale, dbias, dw1, db1, dw2, db2


def fused_mlp(x, ln_weight, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """x + fc2(QuickGELU(fc1(LN(x)))) from the stored parameters: the training
    Function (kernel 2's training form on CUDA) where a gradient is to flow,
    else the eval kernel on weights cast to the dtype of x."""
    if needs_grad(x, ln_weight, ln_bias, w1, b1, w2, b2):
        return FusedMlpBlockFn.apply(x, ln_weight, ln_bias, w1, b1, w2, b2)
    return fused_mlp_block(x, ln_weight, ln_bias, w1.to(x.dtype), b1, w2.to(x.dtype), b2)
