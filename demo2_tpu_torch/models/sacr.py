"""SACR, scale-adaptive contextual refinement, and its multi-modal forms
(demo2_tpu/models/sacr.py: eca_kernel_size, ConvBNReLU, _SACRCore, SACR,
MultiModalSACR, MultiModalSACRv2).

The convolutions run over channels-last (B, H, W, C) token grids
(ops/conv.py); the shared SACR takes the three modalities as one (3B, H, W,
C) batch, the multi-modal forms stack the modalities along H so that the
atrous convolutions mix them.  The ECA channel attention is a 1-D
convolution over the channel axis.  The BatchNorms use batch statistics in
training.  No kernel of csrc/ runs here: the JAX package computes these
convolutions outside any Pallas kernel too.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MultiHeadAttention
from ..ops.conv import Conv2d, lecun_normal_init
from ..ops.linear import cached_cast, make_param, truncated_normal_init
from ..ops.norm import LayerNorm, TorchBatchNorm

NUM_MODALITIES = 3


def eca_kernel_size(channels: int) -> int:
    """The adaptive odd kernel size of the channel attention, at least 3."""
    k = int(abs((math.log2(channels) + 1) / 2))
    k = k if k % 2 else k + 1
    return max(k, 3)


class ConvBNReLU(nn.Module):
    """Conv (no bias, padding dilation * (k // 2)) + BatchNorm + ReLU."""

    def __init__(self, in_features: int, features: int, kernel: int = 1, dilation: int = 1, *,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel, dilation=dilation, dtype=dtype,
                           device=device, generator=generator)
        self.bn = TorchBatchNorm(features, device=device, use_bias=True)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), train))


class ChannelConv(nn.Module):
    """ECA's 1-D convolution (no bias) over the channel axis of a pooled
    (B, C) map: a Conv1d weight (1, 1, k), flax's (k, 1, 1) kernel transposed."""

    def __init__(self, channels: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        k = eca_kernel_size(channels)
        self.dtype = dtype
        self.weight = make_param((1, 1, k), lecun_normal_init(k), generator=generator,
                                 device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        return F.conv1d(x.to(self.dtype)[:, None, :], cached_cast(self, "weight", self.dtype),
                        padding=k // 2)[:, 0]


class _SACRCore(nn.Module):
    """Atrous pyramid + 1x1 fusion + ECA channel attention over (B, H, W, C)."""

    def __init__(self, token_dim: int, dilation_rates: Sequence[int], *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        c = token_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1x1 = ConvBNReLU(c, c, 1, **kw)
        for i, r in enumerate(dilation_rates):
            setattr(self, f"atrous_{i}", ConvBNReLU(c, c, 3, r, **kw))
        self.num_atrous = len(dilation_rates)
        self.fusion = ConvBNReLU((1 + len(dilation_rates)) * c, c, 1, **kw)
        self.channel_attn = ChannelConv(c, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        feats = [self.conv1x1(x, train)]
        feats += [getattr(self, f"atrous_{i}")(x, train) for i in range(self.num_atrous)]
        feat = self.fusion(torch.cat(feats, dim=-1), train)
        gap = feat.float().mean((1, 2)).to(feat.dtype)  # (B, C), f32 sums as jnp.mean
        attn = torch.sigmoid(self.channel_attn(gap).float()).to(feat.dtype)
        return feat * attn[:, None, None, :]


class SACR(nn.Module):
    """One SACR shared by the three modalities: tokens (3, B, N, C) on an
    (H, W) grid, as one (3B, H, W, C) batch."""

    def __init__(self, token_dim: int, height: int, width: int,
                 dilation_rates: Sequence[int] = (2, 3, 4), *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.height, self.width = height, width
        self.core = _SACRCore(token_dim, dilation_rates, dtype=dtype, device=device,
                              generator=generator)

    def forward(self, tokens: torch.Tensor, train: bool = False) -> torch.Tensor:
        m, b, n, c = tokens.shape
        out = self.core(tokens.reshape(m * b, self.height, self.width, c), train)
        return out.reshape(m, b, n, c)


def _stack_modalities(tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(M, B, N, C) -> (B, M * H, W, C): the modalities' grids stacked along H."""
    m, b, n, c = tokens.shape
    return tokens.transpose(0, 1).reshape(b, m * height, width, c)


class MultiModalSACR(nn.Module):
    """v1: the modalities stacked along H, then a 1x1 cross-modal residual."""

    def __init__(self, token_dim: int, height: int, width: int,
                 dilation_rates: Sequence[int] = (2, 3, 4), *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.height, self.width = height, width
        self.core = _SACRCore(token_dim, dilation_rates, **kw)
        self.cross_modal = ConvBNReLU(token_dim, token_dim, 1, **kw)

    def forward(self, tokens: torch.Tensor, train: bool = False) -> torch.Tensor:
        m, b, n, c = tokens.shape
        feat = self.core(_stack_modalities(tokens, self.height, self.width), train)
        feat = feat + self.cross_modal(feat, train)
        return feat.reshape(b, m, n, c).transpose(0, 1)


class MultiModalSACRv2(nn.Module):
    """v2: a learned embedding per modality, the stacked SACR core, then an
    8-head self-attention over the 3N tokens behind a LayerNorm, residual."""

    def __init__(self, token_dim: int, height: int, width: int,
                 dilation_rates: Sequence[int] = (2, 3, 4), *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        c = token_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.height, self.width = height, width
        self.dtype = dtype
        self.modal_embed = make_param((NUM_MODALITIES, 1, c), truncated_normal_init(0.02),
                                      generator=generator, device=device)
        self.core = _SACRCore(c, dilation_rates, **kw)
        self.cross_modal_norm = LayerNorm(c, device=device)
        self.cross_modal_attn = MultiHeadAttention(c, 8, **kw)

    def forward(self, tokens: torch.Tensor, train: bool = False) -> torch.Tensor:
        m, b, n, c = tokens.shape
        tokens = tokens + cached_cast(self, "modal_embed", tokens.dtype)[:, None]
        feat = self.core(_stack_modalities(tokens, self.height, self.width), train)
        seq = feat.reshape(b, m * n, c)
        seq = seq + self.cross_modal_attn(self.cross_modal_norm(seq))
        return seq.reshape(b, m, n, c).transpose(0, 1)
