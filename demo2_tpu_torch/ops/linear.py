"""Linear layer, seeded initialisers and cached dtype casts.

Parameters are stored in f32, as the JAX package stores them
(param_dtype=float32), and cast to the compute dtype at use.  Outside
training the cast is cached per parameter (`cached_cast`) so that a bf16
model casts each weight once, not once per call; in training it is a
differentiable cast, so the gradient reaches the f32 parameter.

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
    """`module.<name>` as a contiguous tensor of `dtype`.

    Where a gradient is to flow back to the parameter (grad mode on and the
    parameter requires grad), the cast is a differentiable `to(dtype)` made
    anew on every call: its graph belongs to the step that made it.  Else
    (no-grad, inference, buffers) the detached cast is made once and reused
    until the parameter is replaced or written in place."""
    t = getattr(module, name)
    if t is None or (t.dtype == dtype and t.is_contiguous()):
        return t
    return cached_merge(module, name, (t,), dtype, lambda: t)


def cached_merge(module: nn.Module, name: str, tensors, dtype: torch.dtype,
                 make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """`make()` (a weight computed from the parameters `tensors`: a cast, a
    LoRA merge) as a contiguous tensor of `dtype`: differentiable and made
    anew where a gradient is to flow to one of `tensors`, else made once and
    reused until one of them is replaced or written in place (an optimizer
    step), so that an eval forward never serves a stale weight.  A result
    made under inference_mode is an inference tensor, which autograd may not
    save: it serves inference_mode calls only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return make().to(dtype).contiguous()
    cache = module.__dict__.setdefault("_cast_cache", {})
    key = (tuple((t.data_ptr(), t._version) for t in tensors), tensors[0].device,
           torch.is_inference_mode_enabled())
    hit = cache.get((name, dtype))
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, make().to(dtype).contiguous())
        cache[(name, dtype)] = hit
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
