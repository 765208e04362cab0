"""Model factory (demo2_tpu/models/factory.py)."""

from __future__ import annotations

import torch

from ..config.defaults import Config
from .demo import DeMo


def make_model(cfg: Config, num_class: int, camera_num: int, *,
               device: torch.device, generator: torch.Generator) -> DeMo:
    """The model on `device`, its weights drawn from `generator` (a CPU
    torch.Generator: one seed gives the same weights on every device).  Each
    forward selects eval or training with its `train` argument."""
    return DeMo(cfg, num_class, camera_num, device=device, generator=generator).eval()
