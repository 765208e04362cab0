"""LayerNorm and BatchNorm / BNNeck with torch semantics (demo2_tpu/ops/norm.py)."""

from __future__ import annotations

import torch
from torch import nn

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


class LayerNorm(nn.Module):
    """flax LayerNorm(epsilon=eps); the ImageNet ViT uses 1e-6."""

    def __init__(self, features: int, *, device: torch.device, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.weight = make_param((features,), ones_init, generator=None, device=device)
        self.bias = make_param((features,), zeros_init, generator=None, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
            mean = xf.mean(dims)
            # Centered form: E[x^2] - E[x]^2 can go negative in f32.
            var = (xf - mean).square().mean(dims)
            n = xf.numel() // xf.shape[-1]
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


class BNNeck(nn.Module):
    """Bias-free BatchNorm1d (the reference freezes the BN bias at zero)."""

    def __init__(self, features: int, *, device: torch.device):
        super().__init__()
        self.bn = TorchBatchNorm(features, device=device, use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(x, train)
