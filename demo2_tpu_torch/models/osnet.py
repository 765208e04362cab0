"""OSNet backbone, the omni-scale network, and its AIN variant
(demo2_tpu/models/osnet.py).

Every OSBlock runs four streams of 1 to 4 light convolutions (a pointwise
conv, then a DEPTHWISE 3x3, groups = channels, BatchNorm and ReLU), gates each
with ONE ChannelGate shared by the four (a shared parameter, as in the
reference), sums them and adds the block's input through a linear bottleneck.
Stage transitions are a 1x1 conv and a 2x2 average pool.  osnet_ain takes an
InstanceNorm in conv1 and, in the blocks OSNET_AIN_VARIANTS marks "ain", an
affine InstanceNorm in place of conv3's BatchNorm, before the add.  Maps are
channels-last at the edges and inside, the convolutions are
ops/conv.py::Conv2d (cuDNN on the card; JAX leaves them to XLA), the
BatchNorms flax's (ops/norm.py::FlaxBatchNorm), and the names the flax
module's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import Conv2d
from ..ops.norm import FlaxBatchNorm, InstanceNorm
from .resnet import max_pool_3x3_s2


class ConvBNRelu(nn.Module):
    """_ConvBNRelu: conv (padding (kernel - 1) // 2, no bias) + BN or IN +
    optional ReLU."""

    def __init__(self, in_features: int, features: int, kernel: int = 1, stride: int = 1, *,
                 use_in: bool = False, relu: bool = True, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.use_in, self.relu = use_in, relu
        self.conv = Conv2d(in_features, features, kernel, stride=stride, dtype=dtype,
                           device=device, generator=generator)
        if use_in:
            setattr(self, "in", InstanceNorm(features, device=device))
        else:
            self.bn = FlaxBatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.conv(x)
        x = getattr(self, "in")(x) if self.use_in else self.bn(x, train)
        return F.relu(x) if self.relu else x


class LightConv3x3(nn.Module):
    """1x1 linear + depthwise 3x3 + BN + ReLU."""

    def __init__(self, features: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.conv1 = Conv2d(features, features, 1, **kw)
        self.conv2 = Conv2d(features, features, 3, groups=features, **kw)
        self.bn = FlaxBatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.relu(self.bn(self.conv2(self.conv1(x)), train))


class ChannelGate(nn.Module):
    """Squeeze and gate: x * sigmoid(fc2(relu(fc1(mean over H, W))))."""

    def __init__(self, channels: int, reduction: int = 16, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator, bias=True)
        self.fc1 = Conv2d(channels, max(1, channels // reduction), 1, **kw)
        self.fc2 = Conv2d(max(1, channels // reduction), channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.fc2(F.relu(self.fc1(x.mean((1, 2), keepdim=True))))
        return x * torch.sigmoid(g)


class OSBlock(nn.Module):
    """Four gated streams + linear bottleneck + residual; `ain` is
    OSBlockINin (conv3 without BN, an affine IN before the add), `use_in`
    the osnet_ibn flavour's IN after it."""

    def __init__(self, in_features: int, features: int, *, use_in: bool = False,
                 ain: bool = False, reduction: int = 4, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        mid = features // reduction
        self.ain = ain
        self.conv1 = ConvBNRelu(in_features, mid, 1, **kw)
        self.gate = ChannelGate(mid, **kw)  # shared by the four streams
        self.streams = [[f"conv2{'abcd'[si]}_{ci}" for ci in range(si + 1)] for si in range(4)]
        for names in self.streams:
            for name in names:
                setattr(self, name, LightConv3x3(mid, **kw))
        if ain:
            self.conv3 = Conv2d(mid, features, 1, **kw)
            self.in3 = InstanceNorm(features, device=device)
        else:
            self.conv3 = ConvBNRelu(mid, features, 1, relu=False, **kw)
        self.downsample = (ConvBNRelu(in_features, features, 1, relu=False, **kw)
                           if in_features != features else None)
        self.in_out = InstanceNorm(features, device=device) if use_in else None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x1 = self.conv1(x, train)
        streams = []
        for names in self.streams:
            y = x1
            for name in names:
                y = getattr(self, name)(y, train)
            streams.append(self.gate(y))
        x2 = sum(streams)
        x3 = self.in3(self.conv3(x2)) if self.ain else self.conv3(x2, train)
        out = x3 + (x if self.downsample is None else self.downsample(x, train))
        if self.in_out is not None:
            out = self.in_out(out)
        return F.relu(out)


# name -> (layers per stage, stage channels), JAX's OSNET_CONFIGS
OSNET_CONFIGS = {
    "osnet_x1_0": ((2, 2, 2), (64, 256, 384, 512)),
    "osnet_x0_5": ((2, 2, 2), (32, 128, 192, 256)),
    "osnet_x0_25": ((2, 2, 2), (16, 64, 96, 128)),
    "osnet_ain_x1_0": ((2, 2, 2), (64, 256, 384, 512)),
    "osnet_ain_x0_5": ((2, 2, 2), (32, 128, 192, 256)),
}

# osnet_ain's block pattern, per stage and block.
OSNET_AIN_VARIANTS = (("ain", "ain"), ("plain", "ain"), ("ain", "plain"))


class OSNet(nn.Module):
    """The trunk: (B, H, W, 3) -> conv5's map (B, H / 16, W / 16, channels[3])."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2),
                 channels: Sequence[int] = (64, 256, 384, 512), *, use_in: bool = False,
                 block_variants=None, conv1_in: bool = False, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, generator=generator)
        ch = channels
        self.conv1 = ConvBNRelu(3, ch[0], 7, 2, use_in=use_in or conv1_in, **kw)
        self.stages = []
        inplanes = ch[0]
        for stage in range(3):
            names = []
            for j in range(layers[stage]):
                variant = block_variants[stage][j] if block_variants is not None else "plain"
                name = f"conv{stage + 2}_{j}"
                setattr(self, name, OSBlock(inplanes, ch[stage + 1],
                                            use_in=use_in and stage == 0,
                                            ain=variant == "ain", **kw))
                names.append(name)
                inplanes = ch[stage + 1]
            if stage < 2:  # the transitions after conv2 and conv3
                setattr(self, f"transition{stage + 2}", ConvBNRelu(inplanes, ch[stage + 1], 1,
                                                                   **kw))
            self.stages.append(names)
        self.conv5 = ConvBNRelu(inplanes, ch[3], 1, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = max_pool_3x3_s2(self.conv1(x.to(self.dtype), train))
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, train)
            if stage < 2:
                x = getattr(self, f"transition{stage + 2}")(x, train)
                x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return self.conv5(x, train)
