"""FRCA, Fourier residual channel attention (demo2_tpu/models/frca.py: CLC,
DNRU, _grid_dims, FourierResidualChannelAttention).

Over a (B, H, W, C) token grid: a 3x3 conv stack, then channel weights from
the 2-D FFT of the channel descriptor laid out on a near-square grid, its
amplitude and phase each modulated by a 1x1 conv stack (f32 throughout, as
the JAX package forces), a sigmoid and a residual, then a depthwise 3x3
conv + GroupNorm + ReLU.  The FFTs are torch.fft's (cuFFT on the card): the
JAX package computes them outside any Pallas kernel too.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Conv2d
from ..ops.norm import GroupNorm, choose_gn_groups


class CLC(nn.Module):
    """Conv k -> LeakyReLU -> Conv k ("SAME", no bias)."""

    def __init__(self, features: int, kernel: int = 3, negative_slope: float = 0.1, *,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.negative_slope = negative_slope
        self.conv0 = Conv2d(features, features, kernel, **kw)
        self.conv1 = Conv2d(features, features, kernel, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(F.leaky_relu(self.conv0(x), self.negative_slope))


class DNRU(nn.Module):
    """Depthwise 3x3 conv + GroupNorm + ReLU."""

    def __init__(self, channels: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.dwconv = Conv2d(channels, channels, 3, groups=channels, dtype=dtype,
                             device=device, generator=generator)
        self.gn = GroupNorm(choose_gn_groups(channels), channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.gn(self.dwconv(x)))


def _grid_dims(c: int) -> Tuple[int, int, int]:
    """(rows, cols, padded cells) of the near-square grid of C channels."""
    hc = int(math.floor(math.sqrt(c)))
    wc = int(math.ceil(c / hc))
    return hc, wc, hc * wc - c


def real_bins(hc: int, wc: int, device: torch.device) -> torch.Tensor:
    """(hc, wc) bool: the bins whose value is real for a real input, rows 0
    and hc / 2 (where even) crossed with columns 0 and wc / 2 (where even)."""
    def axis(n):
        return torch.tensor([i == 0 or 2 * i == n for i in range(n)], device=device)

    return axis(hc)[:, None] & axis(wc)[None, :]


def channel_spectrum(desc: torch.Tensor) -> torch.Tensor:
    """The f32 2-D FFT of the (B, C) descriptor zero-padded onto its grid.

    At the real bins the imaginary part is set to +0, its exact value: an
    FFT leaves round-off of either sign there (numpy's and XLA's do on the
    22 x 24 grid of C = 512), and the phase, +-pi by that sign where the real
    part is negative, enters `pha * clc1(pha)`, which is not odd.  So the
    phase there is 0 or pi by the sign of the real part, on every device."""
    hc, wc, pad = _grid_dims(desc.shape[-1])
    spec = torch.fft.fft2(F.pad(desc.float(), (0, pad)).reshape(-1, hc, wc))
    imag = torch.where(real_bins(hc, wc, desc.device), 0.0, spec.imag)
    return torch.complex(spec.real, imag)


class FourierResidualChannelAttention(nn.Module):
    def __init__(self, channels: int, negative_slope: float = 0.1, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        c = channels
        kw = dict(device=device, generator=generator)
        self.negative_slope = negative_slope
        self.clc3 = CLC(c, 3, negative_slope, dtype=dtype, **kw)
        # The 1x1 stacks over the (one-channel) spectrum: f32 scalars.
        for name in ("clc1_amp", "clc1_pha"):
            for i in (0, 1):
                setattr(self, f"{name}_conv{i}", Conv2d(1, 1, 1, dtype=torch.float32, **kw))
        self.dnru = DNRU(c, dtype=dtype, **kw)

    def _clc1(self, name: str, v: torch.Tensor) -> torch.Tensor:
        w0 = getattr(self, f"{name}_conv0").weight.reshape(())
        w1 = getattr(self, f"{name}_conv1").weight.reshape(())
        return F.leaky_relu(v * w0, self.negative_slope) * w1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H, W, C)."""
        c = x.shape[-1]
        feat = self.clc3(x)
        spec = channel_spectrum(feat.float().mean((1, 2)))
        amp, pha = spec.abs(), spec.angle()
        amp = amp * self._clc1("clc1_amp", amp)
        pha = pha * self._clc1("clc1_pha", pha)
        grid = torch.fft.ifft2(torch.complex(amp * torch.cos(pha), amp * torch.sin(pha))).real
        weight = torch.sigmoid(grid.reshape(grid.shape[0], -1)[:, :c]).to(feat.dtype)
        return self.dnru(feat * weight[:, None, None, :] + x)
