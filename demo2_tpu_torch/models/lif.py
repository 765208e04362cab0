"""Trimodal-LIF: quality-aware reweighting of the three modalities
(demo2_tpu/models/lif.py: _avg_pool, ConvBNSiLU, QualityPredictor,
TrimodalLIF, _resize_bilinear, rgb_quality / nir_quality / tir_quality,
lif_loss, lif_reweight).

Three conv predictors, one per modality, map the images to (h, w) quality
maps at 1/8 of the image; their self-supervised targets (RGB luminance, NIR
Laplacian local variance, TIR local standard deviation) are computed in f32
from the images, and the patches of each grid cell are reweighted by a
softmax over the modalities of the resized maps.  Pools count their padding
(count_include_pad), and resizes are bilinear without antialiasing, as
torch's interpolate does.  No kernel of csrc/ runs here: the JAX package
computes these convolutions outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Conv2d
from ..ops.norm import TorchBatchNorm
from ..parallel.collectives import batch_mean

MODALITIES = ("rgb", "nir", "tir")


def _avg_pool(x: torch.Tensor, window: int, stride: int, pad: int) -> torch.Tensor:
    """Average pool over (B, H, W, C), the padding counted in the average."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride, pad, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def _resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, *size, C): F.interpolate(mode='bilinear',
    align_corners=False), no antialiasing even where it shrinks."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


class ConvBNSiLU(nn.Module):
    """3x3 conv ("SAME", no bias) + BatchNorm + SiLU."""

    def __init__(self, in_features: int, features: int, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.conv = Conv2d(in_features, features, 3, dtype=dtype, device=device,
                           generator=generator)
        self.bn = TorchBatchNorm(features, device=device, use_bias=True)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x), train))


class QualityPredictor(nn.Module):
    """(B, H, W, 3) images -> (B, H/8, W/8, 1) quality map."""

    def __init__(self, mid_channels: int = 64, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.c0 = ConvBNSiLU(3, 32, **kw)
        self.c1 = ConvBNSiLU(32, mid_channels, **kw)
        self.c2 = ConvBNSiLU(mid_channels, mid_channels, **kw)
        self.head = Conv2d(mid_channels, 1, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for conv in (self.c0, self.c1, self.c2):
            x = _avg_pool(conv(x, train), 2, 2, 0)
        return torch.relu(self.head(x))


class TrimodalLIF(nn.Module):
    """An independent predictor per modality: images (B, 3, H, W, 3) ->
    quality maps (3, B, h, w, 1)."""

    def __init__(self, mid_channels: int = 64, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        for nm in MODALITIES:
            setattr(self, f"{nm}_predictor",
                    QualityPredictor(mid_channels, dtype=dtype, device=device,
                                     generator=generator))

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.stack([getattr(self, f"{nm}_predictor")(images[:, i], train)
                            for i, nm in enumerate(MODALITIES)])


# ---------------- self-supervised quality targets ----------------------------


def rgb_quality(rgb: torch.Tensor, target: Tuple[int, int]) -> torch.Tensor:
    """BT.601 luminance of (B, H, W, 3), resized to `target`."""
    lum = 0.299 * rgb[..., 0:1] + 0.587 * rgb[..., 1:2] + 0.114 * rgb[..., 2:3]
    return _resize_bilinear(lum, target)


def _max_normalized(q: torch.Tensor) -> torch.Tensor:
    return q / (q.amax(dim=(1, 2), keepdim=True) + 1e-6)


def nir_quality(nir: torch.Tensor, target: Tuple[int, int], kernel: int = 15) -> torch.Tensor:
    """The local variance of the Laplacian of the grey image, resized and
    divided by its maximum."""
    g = nir.mean(-1, keepdim=True)
    lap_kernel = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                              dtype=g.dtype, device=g.device).reshape(1, 1, 3, 3)
    lap = F.conv2d(g.permute(0, 3, 1, 2), lap_kernel, padding=1).permute(0, 2, 3, 1)
    pad = kernel // 2
    mean = _avg_pool(lap, kernel, 1, pad)
    mean_sq = _avg_pool(lap.square(), kernel, 1, pad)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    return _max_normalized(_resize_bilinear(var, target))


def tir_quality(tir: torch.Tensor, target: Tuple[int, int], kernel: int = 15) -> torch.Tensor:
    """The local standard deviation of the grey image, resized and divided by
    its maximum."""
    g = tir.mean(-1, keepdim=True)
    pad = kernel // 2
    mean = _avg_pool(g, kernel, 1, pad)
    mean_sq = _avg_pool(g.square(), kernel, 1, pad)
    std = torch.sqrt(torch.clamp(mean_sq - mean.square(), min=0.0) + 1e-6)
    return _max_normalized(_resize_bilinear(std, target))


def lif_loss(quality_maps: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """The summed MSE of the three maps (3, B, h, w, 1) against their targets
    from `images` (B, 3, H, W, 3), in f32; each MSE over the global batch
    under data parallelism."""
    target = tuple(quality_maps.shape[2:4])
    imgs = images.float()
    q = quality_maps.float()
    gts = (rgb_quality(imgs[:, 0], target), nir_quality(imgs[:, 1], target),
           tir_quality(imgs[:, 2], target))
    return sum(batch_mean((q[i] - gt).square()) for i, gt in enumerate(gts))


def lif_reweight(patches: torch.Tensor, quality_maps: torch.Tensor,
                 patch_grid: Tuple[int, int], temperature: float) -> torch.Tensor:
    """patches (3, B, N, C) times the softmax over the modalities of the
    quality maps (3, B, h, w, 1) resized to the patch grid, times `temperature`."""
    m, b, n, c = patches.shape
    q = _resize_bilinear(quality_maps.reshape(m * b, *quality_maps.shape[2:]), patch_grid)
    w = torch.softmax(q.reshape(m, b, n).float() * temperature, dim=0)
    return patches * w[..., None].to(patches.dtype)
