"""ResNet backbone with the Re-ID last stride and the IBN-Net variants
(demo2_tpu/models/resnet.py).

Bottleneck ResNet-50 / 101 / 152 with layer4 at stride 1 (a 16-stride map,
16 x 8 at 256 x 128), IBN-a (the first norm of every block of layers 1-3
split: InstanceNorm on the first half of the channels, BatchNorm on the rest)
and IBN-b (an InstanceNorm stem, and an InstanceNorm after the residual add
of the last block of layers 1 and 2).  Maps are channels-last (B, H, W, C) at
the module's edges and inside, as in JAX; the convolutions are
ops/conv.py::Conv2d (cuDNN on the card, as JAX leaves them to XLA: no Pallas
kernel runs here).  The BatchNorms are flax's (ops/norm.py::FlaxBatchNorm):
batch statistics in training, which update the running ones, the running
ones at eval.  Module and parameter names are the flax module's, so
utils/converters.py fills the port from a JAX variable tree.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Conv2d
from ..ops.norm import FlaxBatchNorm, InstanceNorm


class ConvBN(nn.Module):
    """_ConvBN: conv (no bias, padding (kernel - 1) // 2) + norm, where norm is
    "bn", "in" (the IBN-b stem) or "ibn" (IN on the first half, BN on the
    rest)."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1, *,
                 norm: str = "bn", dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.norm = norm
        self.conv = Conv2d(in_features, features, kernel, stride=stride, dtype=dtype,
                           device=device, generator=generator)
        self.half = features // 2
        if norm in ("in", "ibn"):
            setattr(self, "in", InstanceNorm(self.half if norm == "ibn" else features,
                                             device=device))
        if norm in ("bn", "ibn"):
            self.bn = FlaxBatchNorm(features - self.half if norm == "ibn" else features,
                                    device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.conv(x)
        if self.norm == "in":
            return getattr(self, "in")(x)
        if self.norm == "ibn":
            return torch.cat([getattr(self, "in")(x[..., :self.half]),
                              self.bn(x[..., self.half:], train)], dim=-1)
        return self.bn(x, train)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with a projection shortcut; `ibn`
    makes cb1's norm the IBN-a split, `ibn_b` adds the InstanceNorm after the
    add."""

    def __init__(self, in_features: int, planes: int, stride: int = 1, *,
                 downsample: bool = False, ibn: bool = False, ibn_b: bool = False,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.cb1 = ConvBN(in_features, planes, 1, norm="ibn" if ibn else "bn", **kw)
        self.cb2 = ConvBN(planes, planes, 3, stride, **kw)
        self.cb3 = ConvBN(planes, planes * 4, 1, **kw)
        self.down = ConvBN(in_features, planes * 4, 1, stride, **kw) if downsample else None
        self.in_out = InstanceNorm(planes * 4, device=device) if ibn_b else None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.cb1(x, train))
        y = F.relu(self.cb2(y, train))
        y = self.cb3(y, train)
        out = y + (x if self.down is None else self.down(x, train))
        if self.in_out is not None:
            out = self.in_out(out)
        return F.relu(out)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """flax nn.max_pool((3, 3), strides (2, 2), padding 1) on (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class ResNet(nn.Module):
    """The trunk: (B, H, W, 3) -> layer4's map (B, H', W', 2048).  `ibn` is
    False / "none", True / "a" or "b"."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), last_stride: int = 1, ibn=False,
                 *, dtype: torch.dtype, device: torch.device, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        mode = {True: "a", False: "none"}.get(ibn, ibn)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.stem = ConvBN(3, 64, 7, 2, norm="in" if mode == "b" else "bn", **kw)
        self.names = []
        inplanes = 64
        for i, (n, s) in enumerate(zip(layers, (1, 2, 2, last_stride))):
            planes = 64 * 2**i
            for j in range(n):
                name = f"layer{i + 1}_{j}"
                setattr(self, name, Bottleneck(
                    inplanes, planes, s if j == 0 else 1, downsample=j == 0,
                    ibn=mode == "a" and planes != 512, ibn_b=mode == "b" and i < 2 and j == n - 1,
                    **kw))
                self.names.append(name)
                inplanes = planes * 4

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = max_pool_3x3_s2(F.relu(self.stem(x.to(self.dtype), train)))
        for name in self.names:
            x = getattr(self, name)(x, train)
        return x


# name -> (layers, ibn mode), JAX's RESNET_CONFIGS
RESNET_CONFIGS = {
    "resnet50": ((3, 4, 6, 3), False),
    "resnet101": ((3, 4, 23, 3), False),
    "resnet152": ((3, 8, 36, 3), False),
    "resnet50_ibn_a": ((3, 4, 6, 3), "a"),
    "resnet50_ibn_b": ((3, 4, 6, 3), "b"),
}


def resnet_tokens(feature_map: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) map -> (global average (B, C), tokens (B, H*W, C)): the
    CNN counterpart of the ViT's CLS / patch split that PIFE returns."""
    b, h, w, c = feature_map.shape
    return feature_map.mean((1, 2)), feature_map.reshape(b, h * w, c)
