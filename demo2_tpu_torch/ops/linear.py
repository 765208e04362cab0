"""Linear layer, seeded initialisers and cached dtype casts.

Parameters are stored in f32, as the JAX package stores them
(param_dtype=float32), and cast to the compute dtype at use.  The cast is
cached per parameter (`cached_cast`) so that a bf16 model casts each weight
once, not once per call.

Initialisers follow the flax ones of demo2_tpu/ops/linear.py and draw from
an explicit CPU `torch.Generator`; the values are then moved to `device`, so
one seed gives the same weights on every device.  Weights are in torch's
Linear layout (out, in): a flax kernel (in, out) is its transpose.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Init = Callable[[Sequence[int], torch.Generator], torch.Tensor]


def uniform_init(bound: float) -> Init:
    def init(shape, generator):
        return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) * bound

    return init


def normal_init(std: float) -> Init:
    def init(shape, generator):
        return torch.randn(tuple(shape), generator=generator) * std

    return init


def truncated_normal_init(std: float) -> Init:
    """flax `truncated_normal(std)`: a standard normal cut at +-2, times std."""

    def init(shape, generator):
        t = torch.empty(tuple(shape))
        return nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator) * std

    return init


def zeros_init(shape, generator):
    return torch.zeros(tuple(shape))


def ones_init(shape, generator):
    return torch.ones(tuple(shape))


def torch_linear_init(fan_in: int) -> Init:
    """U(+-1/sqrt(fan_in)), flax variance_scaling(1/3, 'fan_in', 'uniform')."""
    return uniform_init(1.0 / math.sqrt(fan_in))


def xavier_uniform_init(fan_in: int, fan_out: int) -> Init:
    return uniform_init(math.sqrt(6.0 / (fan_in + fan_out)))


def make_param(shape, init: Init, *, generator: torch.Generator,
               device: torch.device) -> nn.Parameter:
    return nn.Parameter(init(shape, generator).to(device=device, dtype=torch.float32))


def cached_cast(module: nn.Module, name: str, dtype: torch.dtype) -> Optional[torch.Tensor]:
    """`module.<name>` as a contiguous tensor of `dtype`, cast once and reused
    until the parameter is replaced or written in place."""
    t = getattr(module, name)
    if t is None or (t.dtype == dtype and t.is_contiguous()):
        return t
    cache = module.__dict__.setdefault("_cast_cache", {})
    key = (t.data_ptr(), t._version, t.device, dtype)
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        hit = (key, t.detach().to(dtype).contiguous())
        cache[name] = hit
    return hit[1]


class Linear(nn.Module):
    """y = x W^T + b in the compute dtype (flax nn.Dense with dtype=...)."""

    def __init__(self, in_features: int, out_features: int, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator,
                 weight_init: Optional[Init] = None, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        init = weight_init or torch_linear_init(in_features)
        self.weight = make_param((out_features, in_features), init,
                                 generator=generator, device=device)
        self.bias = (make_param((out_features,), zeros_init, generator=generator, device=device)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), cached_cast(self, "weight", self.dtype),
                        cached_cast(self, "bias", self.dtype))
