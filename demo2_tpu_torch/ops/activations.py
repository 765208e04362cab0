"""Activation functions (demo2_tpu/ops/activations.py, and the exact GELU
of demo2_tpu/models/vit.py)."""

import math

import torch


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU, x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU as jax.nn.gelu(approximate=False) writes it:
    0.5 x erfc(-x / sqrt(2)), in the dtype of x."""
    return 0.5 * x * torch.erfc(-x * math.sqrt(0.5))
