"""BNNeck + bias-free classifier head, and the global-local fuse of every
modality (demo2_tpu/models/heads.py); the BNNeck uses batch statistics in
training."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.activations import quick_gelu
from ..ops.linear import Linear, cached_cast, make_param, normal_init, ones_init, uniform_init
from ..ops.linear import zeros_init
from ..ops.norm import EPS, BNNeck


class ClassifierHead(nn.Module):
    def __init__(self, feat_dim: int, num_classes: int, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.bottleneck = BNNeck(feat_dim, device=device)
        self.classifier = Linear(feat_dim, num_classes, bias=False,
                                 weight_init=normal_init(0.001), dtype=torch.float32,
                                 device=device, generator=generator)

    def forward(self, feat: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.classifier(self.bottleneck(feat, train).float())


class GlobalLocalFuse(nn.Module):
    """fuse_global_local of the three modalities: per modality LayerNorm(2C)
    over [global; token mean] -> Linear(2C, C) -> QuickGELU, the parameters
    stacked on a leading (3,) axis in flax's layout (the kernel (3, 2C, C)).
    The LayerNorm runs in f32, the product in the compute dtype."""

    def __init__(self, feat_dim: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator, num_modalities: int = 3):
        super().__init__()
        m, c = num_modalities, feat_dim
        self.dtype = dtype
        kw = dict(generator=generator, device=device)
        self.ln_scale = make_param((m, 2 * c), ones_init, **kw)
        self.ln_bias = make_param((m, 2 * c), zeros_init, **kw)
        # flax variance_scaling(1/3, 'fan_in', 'uniform'): the leading axis
        # counts as receptive field, so fan_in = 3 * 2C.
        self.kernel = make_param((m, 2 * c, c), uniform_init(1.0 / math.sqrt(m * 2 * c)), **kw)
        self.bias = make_param((m, c), zeros_init, **kw)

    def forward(self, tokens: torch.Tensor, globals_: torch.Tensor) -> torch.Tensor:
        """tokens (3, B, N, C), globals_ (3, B, C) -> (3, B, C)."""
        x = torch.cat([globals_, tokens.mean(2)], dim=-1).float()
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        x = (x - mean) * torch.rsqrt(var + EPS)
        x = x * self.ln_scale[:, None, :] + self.ln_bias[:, None, :]
        dt = self.dtype
        y = torch.einsum("mbi,mio->mbo", x.to(dt), cached_cast(self, "kernel", dt))
        return quick_gelu(y + cached_cast(self, "bias", dt)[:, None, :])
