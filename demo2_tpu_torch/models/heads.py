"""BNNeck + bias-free classifier head (demo2_tpu/models/heads.py); the BNNeck
uses batch statistics in training."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.linear import Linear, normal_init
from ..ops.norm import BNNeck


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
