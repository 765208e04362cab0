"""The CLIP ViT block's two fused sub-blocks at eval, each a CUDA kernel
with its plain PyTorch version (demo2_tpu/ops/fused_block.py).

  fused_attention_block: x + out_proj(MHA(LN1(x)))
      replaces the Pallas kernel fused_block.py::_fwd_kernel_infer
      (csrc/fused_attention_block.cu);
  fused_mlp_block:       x + fc2(QuickGELU(fc1(LN2(x))))
      replaces the Pallas kernel fused_block.py::_mlp_kernel
      (csrc/fused_mlp_block.cu).

Each wrapper takes the plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor; there is no fallback between the two: on a
CUDA tensor a missing nvcc, a failed build or a refused launch raises.  Each
wrapper counts its kernel launches in `.launches`.

Weights are in torch's Linear layout (out, in): wqkv (3C, C), wout (C, C),
w1 (4C, C), w2 (C, 4C).  The kernels take x and the weights in bf16 and the
LayerNorm and bias vectors in f32 (the dtypes the Pallas kernels are fed);
callers pass cached casts (ops/linear.py::cached_cast).
"""

from __future__ import annotations

import torch

from .activations import quick_gelu
from .attention import attention_core
from .kernel_lib import check, kernel_library


def _layernorm_f32(x, weight, bias, eps=1e-5):
    """fused_block.py::_layernorm_f32: the whole LayerNorm in f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)) * weight.float() + bias.float()


def packed_self_attention(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Self-attention on packed (B, S, 3C) qkv -> (B, S, C), plain path of
    demo2_tpu/ops/packed_attention.py::packed_self_attention."""
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
    o = packed_self_attention(qkv, num_heads, scale)
    return x + o @ wout.to(dt).t() + bout.to(dt)


def mlp_block_plain(x, ln_weight, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """fused_block.py::_mlp_reference_impl in the dtype of x."""
    dt = x.dtype
    t = _layernorm_f32(x, ln_weight, ln_bias).to(dt)
    h = t @ w1.to(dt).t() + b1.to(dt)
    g = quick_gelu(h).to(dt)
    return x + g @ w2.to(dt).t() + b2.to(dt)


def _expect(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel runs on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _expect_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {x.device}")
    if x.shape[-1] % 8:
        raise ValueError(f"{what}: width {x.shape[-1]} is not a multiple of 8")


def fused_attention_block(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout, *,
                          num_heads: int, scale: float) -> torch.Tensor:
    """x (B, S, C) -> x + out_proj(MHA(LN(x))): the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return attention_block_plain(x, ln_weight, ln_bias, wqkv, bqkv, wout, bout,
                                     num_heads=num_heads, scale=scale)
    _expect_cuda(x, "fused_attention_block")
    b, s, c = x.shape
    dev, f32, bf16 = x.device, torch.float32, torch.bfloat16
    for tensor, name, shape, dtype in (
        (x, "x", (b, s, c), bf16), (ln_weight, "ln_weight", (c,), f32),
        (ln_bias, "ln_bias", (c,), f32), (wqkv, "wqkv", (3 * c, c), bf16),
        (bqkv, "bqkv", (3 * c,), f32), (wout, "wout", (c, c), bf16), (bout, "bout", (c,), f32),
    ):
        _expect(tensor, name, shape, dtype, dev)
    kl = kernel_library()
    head_dim, max_seq = kl.lib.demo2_attention_head_dim(), kl.lib.demo2_attention_max_seq()
    if c != num_heads * head_dim:
        raise ValueError(f"fused_attention_block: the kernel takes heads of {head_dim}, "
                         f"got width {c} / {num_heads} heads")
    if s > max_seq:
        raise ValueError(f"fused_attention_block: sequence {s} exceeds the kernel's {max_seq}")
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
        _expect(tensor, name, shape, dtype, dev)
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
