"""Model factory (demo2_tpu/models/factory.py): MODEL.ARCH 'DeMo_Parallel'
builds DeMoParallel, 'DeMoBeiyong' DeMoLegacy, any other DeMo."""

from __future__ import annotations

import torch
from torch import nn

from ..config.defaults import Config
from .demo import DeMo, DeMoLegacy, DeMoParallel


def make_model(cfg: Config, num_class: int, camera_num: int, view_num: int = 0, *,
               device: torch.device, generator: torch.Generator) -> nn.Module:
    """The model on `device`, its weights drawn from `generator` (a CPU
    torch.Generator: one seed gives the same weights on every device).  Each
    forward selects eval or training with its `train` argument."""
    cls = {"DeMo_Parallel": DeMoParallel, "DeMoBeiyong": DeMoLegacy}.get(cfg.MODEL.ARCH, DeMo)
    return cls(cfg, num_class, camera_num, view_num, device=device, generator=generator).eval()
