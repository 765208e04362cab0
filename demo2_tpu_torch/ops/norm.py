"""LayerNorm and BatchNorm / BNNeck with torch semantics (demo2_tpu/ops/norm.py),
and the one-pass LayerNorm backward.

  layernorm_bwd: dx, dweight, dbias from x, dy and weight in one pass, mean
      and rstd recomputed from x
      replaces the Pallas kernel norm.py::_ln_bwd_kernel
      (csrc/layernorm_bwd.cu, demo2_layernorm_bwd).

`LayerNormFn` is norm.py::layernorm_pallas_bwd, the custom VJP around it:
the forward is `layer_norm`, the same expression as the default route, and
keeps x and weight alone.  `LayerNorm(pallas_bwd=True)`
(cfg.TPU.PALLAS_LN_BWD) selects it.

The wrapper takes the plain version for tensors on the CPU and launches the
kernel for CUDA tensors (it raises on what the kernel does not take); it
counts its launches in `.launches`.

Under data parallelism (parallel/collectives.py) the BatchNorms take their
training statistics over the global batch, as JAX's do over a sharded batch:
the per-rank sums are summed over the ranks (their backward too), and the
running statistics move alike on every rank.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import not_ported
from ..parallel.collectives import active_shard, sum_over_ranks
from .kernel_lib import check, expect, kernel_library
from .linear import cached_cast, make_param, ones_init, zeros_init


EPS = 1e-5


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """demo2_tpu/ops/norm.py::_layernorm_fwd_expr: mean and the centered
    two-pass variance accumulate in f32; for bf16 inputs the normalising
    arithmetic itself stays in bf16."""
    dt = x.dtype
    mean = x.float().mean(-1, keepdim=True)
    d = x - mean.to(dt)
    var = d.square().float().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return d * (rstd.to(dt) * weight.to(dt)) + bias.to(dt)


def layernorm_bwd_plain(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                        eps: float = EPS):
    """_ln_bwd_kernel's arithmetic: everything in f32, mean and the centered
    variance recomputed from x.  x, dy (R, C), weight (C,) ->
    (dx (R, C) in dy's dtype, dweight (C,) f32, dbias (C,) f32)."""
    xf, dyf, g = x.float(), dy.float(), weight.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    dyg = dyf * g
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    dx = (rstd * (dyg - m1 - xhat * m2)).to(dy.dtype)
    return dx, (dyf * xhat).sum(0), dyf.sum(0)


# The kernel keeps a row in a warp's registers, 32 values a lane, and reads
# 16-byte vectors; its column sums go through one partial row per block.
LN_BWD_MAX_COLS = 1024
LN_BWD_WARPS = 8
LN_BWD_MAX_BLOCKS = 264


def check_ln_bwd_limits(cols: int, dtype: torch.dtype) -> None:
    """Raise, naming the ROADMAP item, for an input dtype or a width the
    kernel does not take: bf16 or f32 rows whose width is a multiple of one
    16-byte vector, up to LN_BWD_MAX_COLS.  The Pallas kernel takes any width."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise not_ported(f"layernorm_bwd on {dtype} inputs (the kernel takes bf16 and f32)",
                         "wider heads, longer sequences and f32 inputs in the attention kernels")
    vec = 16 // dtype.itemsize
    if cols % vec or cols > LN_BWD_MAX_COLS:
        raise not_ported(f"layernorm_bwd over {cols} columns (the kernel takes multiples of "
                         f"{vec} up to {LN_BWD_MAX_COLS})", "Kernel 11 beyond 1,024 columns")


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, eps: float = EPS):
    """(dx (R, C) in dy's dtype, dweight (C,) f32, dbias (C,) f32) of a
    LayerNorm over the last axis of x (R, C): the kernel on CUDA tensors, the
    plain version on CPU tensors.  bf16 or f32 x and dy, f32 weight."""
    if x.device.type == "cpu":
        return layernorm_bwd_plain(x, dy, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_bwd: the kernel takes CUDA tensors, got {x.device}")
    rows, cols = x.shape
    check_ln_bwd_limits(cols, x.dtype)
    expect(x, "x", (rows, cols), x.dtype, x.device)
    expect(dy, "dy", (rows, cols), x.dtype, x.device)
    expect(weight, "weight", (cols,), torch.float32, x.device)
    dx = torch.empty_like(dy)
    dweight = torch.empty((cols,), device=x.device, dtype=torch.float32)
    dbias = torch.empty_like(dweight)
    if rows == 0:
        return dx, dweight.zero_(), dbias.zero_()
    kl = kernel_library()
    blocks = min(-(-rows // LN_BWD_WARPS), LN_BWD_MAX_BLOCKS)
    partial = torch.empty((2, blocks, cols), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = kl.lib.demo2_layernorm_bwd(
            x.data_ptr(), dy.data_ptr(), weight.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            dweight.data_ptr(), dbias.data_ptr(), rows, cols, blocks,
            int(x.dtype == torch.bfloat16), float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check(err, "layernorm_bwd")
    layernorm_bwd.launches += 1
    return dx, dweight, dbias


layernorm_bwd.launches = 0


class LayerNormFn(torch.autograd.Function):
    """norm.py::_ln_pallas with its custom VJP: the forward is `layer_norm`
    on the f32 parameters (bit-identical to the default route) and keeps x
    and weight alone; the backward (kernel 11 on CUDA) returns dx in dy's
    dtype and dweight, dbias in f32, straight to the f32 parameters."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        c = x.shape[-1]
        dx, dweight, dbias = layernorm_bwd(x.reshape(-1, c).contiguous(),
                                           dy.reshape(-1, c).contiguous(), weight, ctx.eps)
        return dx.reshape(x.shape), dweight, dbias, None


class LayerNorm(nn.Module):
    """flax LayerNorm(epsilon=eps); the ImageNet ViT uses 1e-6.  With
    `pallas_bwd` the backward is the one-pass kernel (LayerNormFn)."""

    def __init__(self, features: int, *, device: torch.device, eps: float = EPS,
                 pallas_bwd: bool = False):
        super().__init__()
        self.eps = eps
        self.pallas_bwd = pallas_bwd
        self.weight = make_param((features,), ones_init, generator=None, device=device)
        self.bias = make_param((features,), zeros_init, generator=None, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pallas_bwd:
            return LayerNormFn.apply(x, self.weight, self.bias, self.eps)
        return layer_norm(x, cached_cast(self, "weight", x.dtype),
                          cached_cast(self, "bias", x.dtype), self.eps)


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last axis, torch semantics, statistics in f32.

    At eval it normalises with the running statistics.  In training it
    normalises with the batch's (biased) variance and updates the running
    statistics in place: momentum 0.1 in the torch convention, the running
    variance from the unbiased batch variance.
    """

    momentum = 0.1

    def __init__(self, features: int, *, device: torch.device, use_bias: bool):
        super().__init__()
        self.weight = make_param((features,), ones_init, generator=None, device=device)
        self.bias = (make_param((features,), zeros_init, generator=None, device=device)
                     if use_bias else None)
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            dims = tuple(range(x.ndim - 1))
            n = xf.numel() // xf.shape[-1]
            shard = active_shard()
            if shard is None:
                mean = xf.mean(dims)
                # Centered form: E[x^2] - E[x]^2 can go negative in f32.
                var = (xf - mean).square().mean(dims)
            else:  # the global batch's, in two passes as above
                n *= shard.world.size
                mean = sum_over_ranks(xf.sum(dims)) / n
                var = sum_over_ranks((xf - mean).square().sum(dims)) / n
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + EPS)
        y = y * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class FlaxBatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over the last axis, as
    the CNN trunks (demo2_tpu/models/resnet.py, osnet.py) use it.  It differs
    from TorchBatchNorm in flax's conventions: the statistics in f32 (x's
    dtype where that is wider) by the fast variance max(0, E[x^2] - E[x]^2),
    the running statistics updated as 0.9 * running + 0.1 * batch with the
    biased variance, and the output (x - mean) * (rsqrt(var + eps) * scale) +
    bias in that dtype, cast to x's."""

    momentum = 0.9

    def __init__(self, features: int, *, device: torch.device):
        super().__init__()
        self.weight = make_param((features,), ones_init, generator=None, device=device)
        self.bias = make_param((features,), zeros_init, generator=None, device=device)
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            dims = tuple(range(x.ndim - 1))
            shard = active_shard()
            if shard is None:
                mean = xf.mean(dims)
                mean_sq = xf.square().mean(dims)
            else:  # the global batch's: one sum over the ranks of both sums
                n = xf.numel() // xf.shape[-1] * shard.world.size
                mean, mean_sq = sum_over_ranks(torch.stack([xf.sum(dims),
                                                            xf.square().sum(dims)])) / n
            # max(0, .): E[x^2] - E[x]^2 can go negative in f32.
            var = torch.clamp_min(mean_sq - mean.square(), 0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return ((xf - mean) * (torch.rsqrt(var + EPS) * self.weight) + self.bias).to(x.dtype)


class InstanceNorm(nn.Module):
    """Affine InstanceNorm over (B, H, W, C), per sample and channel over H
    and W, with batch statistics at eval too (demo2_tpu/models/resnet.py::
    InstanceNorm).  The statistics accumulate in f32 (or x's wider dtype)
    and, as in JAX, the arithmetic otherwise stays in x's dtype."""

    def __init__(self, features: int, *, device: torch.device):
        super().__init__()
        self.weight = make_param((features,), ones_init, generator=None, device=device)
        self.bias = make_param((features,), zeros_init, generator=None, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, acc = x.dtype, torch.promote_types(x.dtype, torch.float32)
        mean = x.to(acc).mean((1, 2), keepdim=True).to(dt)
        d = x - mean
        var = d.square().to(acc).mean((1, 2), keepdim=True).to(dt)
        y = d * torch.rsqrt(var + EPS)
        return y * cached_cast(self, "weight", dt) + cached_cast(self, "bias", dt)


def choose_gn_groups(channels: int) -> int:
    """The largest group count of 32, 16, 8, 4, 2 that divides C, else 1."""
    return next((g for g in (32, 16, 8, 4, 2) if channels % g == 0), 1)


class GroupNorm(nn.Module):
    """GroupNorm over (B, H, W, C), torch semantics: per-sample statistics of
    each group, in f32."""

    def __init__(self, num_groups: int, features: int, *, device: torch.device):
        super().__init__()
        self.num_groups = num_groups
        self.weight = make_param((features,), ones_init, generator=None, device=device)
        self.bias = make_param((features,), zeros_init, generator=None, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g = self.num_groups
        xf = x.float().reshape(b, h, w, g, c // g)
        mean = xf.mean((1, 2, 4), keepdim=True)
        var = (xf - mean).square().mean((1, 2, 4), keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + EPS)).reshape(b, h, w, c)
        return (y * self.weight + self.bias).to(x.dtype)


class BNNeck(nn.Module):
    """Bias-free BatchNorm1d (the reference freezes the BN bias at zero)."""

    def __init__(self, features: int, *, device: torch.device):
        super().__init__()
        self.bn = TorchBatchNorm(features, device=device, use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(x, train)
