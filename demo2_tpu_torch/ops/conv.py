"""Convolutions over channels-last (B, H, W, C) maps, as flax's nn.Conv takes
them: the weight in torch's (out, in / groups, kh, kw) layout (a flax HWIO
kernel transposed), stored in f32 and cast to the compute dtype at use
(ops/linear.py::cached_cast), so the gradient reaches the f32 parameter.

The map stays channels-last: F.conv2d takes its NCHW view (a permute, no
copy), which cuDNN runs in its NHWC layout on the card.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import nn

from .linear import Init, cached_cast, make_param, truncated_normal_init, zeros_init

# flax lecun_normal draws a normal cut at +-2 and divides by this, its std.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_init(fan_in: int) -> Init:
    """flax nn.Conv's default kernel init, variance_scaling(1, 'fan_in',
    'truncated_normal')."""
    return truncated_normal_init(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


class Conv2d(nn.Module):
    """flax nn.Conv over an odd kernel, padded by dilation * (kernel // 2) on
    each side ("SAME" at stride 1; the CNN trunks' explicit padding of
    (kernel - 1) // 2 at any `stride`); `groups` is its feature_group_count."""

    def __init__(self, in_features: int, out_features: int, kernel: int, *,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator,
                 dilation: int = 1, groups: int = 1, bias: bool = False, stride: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.dilation = dilation
        self.padding = dilation * (kernel // 2)
        self.groups = groups
        self.weight = make_param((out_features, in_features // groups, kernel, kernel),
                                 lecun_normal_init(in_features // groups * kernel * kernel),
                                 generator=generator, device=device)
        self.bias = (make_param((out_features,), zeros_init, generator=generator, device=device)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C_in) -> (B, H, W, C_out) in the compute dtype."""
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), cached_cast(self, "weight", dt),
                     cached_cast(self, "bias", dt), stride=self.stride, padding=self.padding,
                     dilation=self.dilation, groups=self.groups)
        return y.permute(0, 2, 3, 1)
