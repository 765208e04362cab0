"""The CLIP ViT block's fused sub-blocks, each a CUDA kernel with its plain
PyTorch version (demo2_tpu/ops/fused_block.py).

  fused_attention_block:       x + out_proj(MHA(LN1(x))) at eval
      replaces the Pallas kernel fused_block.py::_fwd_kernel_infer
      (csrc/fused_attention_block.cu, demo2_fused_attention_block);
  fused_attention_block_train: the same, plus the residuals qkv, attn and
      the bf16 probs (ops/packed_attention.py's layout) for the backward
      replaces the Pallas kernel fused_block.py::_fwd_kernel
      (csrc/fused_attention_block.cu, demo2_fused_attention_block_train);
  fused_mlp_block:             x + fc2(QuickGELU(fc1(LN2(x)))) at eval
      replaces the Pallas kernel fused_block.py::_mlp_kernel
      (csrc/fused_mlp_block.cu).

`fused_attention` is the block's entry: with grad enabled and an input that
requires grad it runs FusedAttentionBlockFn, the custom VJP of
fused_block.py::_fused (training forward, then _fused_bwd's chain around the
saved-probs attention backward of ops/packed_attention.py); otherwise the
eval kernel, as JAX's primal-only call does.

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
from .packed_attention import (attention_bwd_saved, attention_bwd_saved_db, check_head_limits,
                               merge_heads, needs_grad, probs_cols, probs_shape, split_heads)


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
    b, s, c = x.shape
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    for tensor, name, shape, dtype in (
        (x, "x", (b, s, c), bf16), (ln_weight, "ln_weight", (c,), f32),
        (ln_bias, "ln_bias", (c,), f32), (wqkv, "wqkv", (3 * c, c), bf16),
        (bqkv, "bqkv", (3 * c,), f32), (wout, "wout", (c, c), bf16), (bout, "bout", (c,), f32),
    ):
        expect(tensor, name, shape, dtype, dev)
    return check_head_limits(what, c, num_heads, s)


def fused_attention_block(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                          num_heads: int, scale: float) -> torch.Tensor:
    """x (B, S, C) -> x + out_proj(MHA(LN(x))): the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return attention_block_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                     num_heads=num_heads, scale=scale)
    kl = _check_attention_inputs("fused_attention_block", x, ln_weight, ln_bias, wqkv, bqkv,
                                 wout, bout, num_heads)
    b, s, c = x.shape
    dev, bf16 = x.device, torch.bfloat16
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    t = torch.empty((b * s, c), device=dev, dtype=bf16)
    qkv = torch.empty((b * s, 3 * c), device=dev, dtype=bf16)
    attn = torch.empty((b * s, c), device=dev, dtype=bf16)
    with torch.cuda.device(dev):
        err = kl.lib.demo2_fused_attention_block(
            x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(), out.data_ptr(),
            t.data_ptr(), qkv.data_ptr(), attn.data_ptr(), b, s, c, num_heads,
            float(scale), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "fused_attention_block")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0


def fused_mlp_block(x, ln_weight, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """x (..., C) -> x + fc2(QuickGELU(fc1(LN(x)))): the kernel on CUDA
    tensors, the plain version on CPU tensors.  Unlike the Pallas kernel it
    does not emit the pre-GELU hidden, which only training reads."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_weight, ln_bias, w1, b1, w2, b2)
    _expect_cuda(x, "fused_mlp_block")
    c = x.shape[-1]
    f = w1.shape[0]
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    if f % 8:
        raise ValueError(f"fused_mlp_block: hidden width {f} is not a multiple of 8")
    for tensor, name, shape, dtype in (
        (x, "x", x.shape, bf16), (ln_weight, "ln_weight", (c,), f32),
        (ln_bias, "ln_bias", (c,), f32), (w1, "w1", (f, c), bf16), (b1, "b1", (f,), f32),
        (w2, "w2", (c, f), bf16), (b2, "b2", (c,), f32),
    ):
        expect(tensor, name, shape, dtype, dev)
    kl = kernel_library()
    out = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return out
    t = torch.empty((rows, c), device=dev, dtype=bf16)
    g = torch.empty((rows, f), device=dev, dtype=bf16)
    with torch.cuda.device(dev):
        err = kl.lib.demo2_fused_mlp_block(
            x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), t.data_ptr(),
            g.data_ptr(), rows, c, f, torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "fused_mlp_block")
    fused_mlp_block.launches += 1
    return out


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
    attention_block_train_plain returns them; the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return attention_block_train_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                           num_heads=num_heads, scale=scale)
    kl = _check_attention_inputs("fused_attention_block_train", x, ln_weight, ln_bias, wqkv,
                                 bqkv, wout, bout, num_heads)
    b, s, c = x.shape
    dev, bf16 = x.device, torch.bfloat16
    out = torch.empty_like(x)
    qkv = torch.empty((b, s, 3 * c), device=dev, dtype=bf16)
    attn = torch.empty((b, s, c), device=dev, dtype=bf16)
    probs = torch.empty(probs_shape(b, num_heads, s), device=dev, dtype=bf16)
    if x.numel() == 0:
        return out, qkv, attn, probs
    t = torch.empty((b * s, c), device=dev, dtype=bf16)
    with torch.cuda.device(dev):
        err = kl.lib.demo2_fused_attention_block_train(
            x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(), out.data_ptr(), t.data_ptr(),
            qkv.data_ptr(), attn.data_ptr(), probs.data_ptr(), b, s, c, num_heads,
            float(scale), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "fused_attention_block_train")
    fused_attention_block_train.launches += 1
    return out, qkv, attn, probs


fused_attention_block_train.launches = 0


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
        x, qkv, attn, probs, lnw, lnb, wqkv_c, wout_c = ctx.saved_tensors
        need_x, need_lnw, need_lnb, need_wqkv, need_bqkv, need_wout, need_bout = \
            ctx.needs_input_grad[:7]
        b, s, c = x.shape
        g = g.contiguous()
        gm = g.reshape(-1, c)
        # residual + out-projection
        do = (gm @ wout_c).reshape(b, s, c)
        dwout = _mm_f32(gm.t(), attn.reshape(-1, c)) if need_wout else None
        dbout = gm.float().sum(0) if need_bout else None
        # attention core from the saved probs; db_qkv only where it is wanted
        kw = dict(num_heads=ctx.num_heads, scale=ctx.scale)
        if need_bqkv:
            dqkv, dbqkv = attention_bwd_saved_db(qkv, probs, do, **kw)
        else:
            dqkv, dbqkv = attention_bwd_saved(qkv, probs, do, **kw), None
        dqkv_m = dqkv.reshape(-1, 3 * c)
        dt = dqkv_m @ wqkv_c
        # t recomputed from x (fused_block.py:292-299)
        xf = x.float().reshape(-1, c)
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + 1e-5)
        xhat = (xf - mean) * rstd
        dwqkv = _mm_f32(dqkv_m.t(), (xhat * lnw + lnb).to(x.dtype)) if need_wqkv else None
        # LayerNorm backward in f32
        dtf = dt.float()
        dscale = (dtf * xhat).sum(0) if need_lnw else None
        dbias = dtf.sum(0) if need_lnb else None
        dx = None
        if need_x:
            dxhat = dtf * lnw
            dx_ln = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                            - xhat * (dxhat * xhat).mean(-1, keepdim=True))
            dx = g + dx_ln.reshape(b, s, c).to(g.dtype)
        return dx, dscale, dbias, dwqkv, dbqkv, dwout, dbout, None, None


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
