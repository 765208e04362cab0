"""LayerNorm and the eval-mode BatchNorm / BNNeck (demo2_tpu/ops/norm.py)."""

from __future__ import annotations

import torch
from torch import nn

from .linear import cached_cast, make_param, ones_init, zeros_init


EPS = 1e-5


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """demo2_tpu/ops/norm.py::_layernorm_fwd_expr: mean and the centered
    two-pass variance accumulate in f32; for bf16 inputs the normalising
    arithmetic itself stays in bf16."""
    dt = x.dtype
    mean = x.float().mean(-1, keepdim=True)
    d = x - mean.to(dt)
    var = d.square().float().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + EPS)
    return d * (rstd.to(dt) * weight.to(dt)) + bias.to(dt)


class LayerNorm(nn.Module):
    def __init__(self, features: int, *, device: torch.device):
        super().__init__()
        self.weight = make_param((features,), ones_init, generator=None, device=device)
        self.bias = make_param((features,), zeros_init, generator=None, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, cached_cast(self, "weight", x.dtype),
                          cached_cast(self, "bias", x.dtype))


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last axis at eval: the running statistics, in f32.

    Training-mode batch statistics belong to the training slice, which is
    not ported yet.
    """

    def __init__(self, features: int, *, device: torch.device, use_bias: bool):
        super().__init__()
        self.weight = make_param((features,), ones_init, generator=None, device=device)
        self.bias = (make_param((features,), zeros_init, generator=None, device=device)
                     if use_bias else None)
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + EPS)
        y = y * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class BNNeck(nn.Module):
    """Bias-free BatchNorm1d (the reference freezes the BN bias at zero)."""

    def __init__(self, features: int, *, device: torch.device):
        super().__init__()
        self.bn = TorchBatchNorm(features, device=device, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)
