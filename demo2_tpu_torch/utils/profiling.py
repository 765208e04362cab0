"""Profiling and FLOP accounting (demo2_tpu/utils/profiling.py).

`count_params` counts the model's parameters; `model_flops` the operations
of one forward with torch.utils.flop_counter.FlopCounterMode; `profile_trace`
records a torch.profiler trace for TensorBoard; `ThroughputMeter` logs
samples per second in the reference's per-epoch format.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: torch.nn.Module) -> int:
    """The number of parameter elements (buffers such as BatchNorm
    statistics not counted, as JAX's count of `params` leaves them out)."""
    return sum(p.numel() for p in model.parameters())


@contextlib.contextmanager
def frozen_parameters(model: torch.nn.Module):
    """Every parameter's requires_grad off for the block, restored after."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


@contextlib.contextmanager
def plain_route(model: torch.nn.Module):
    """Every module of `model` on its plain PyTorch route for the duration:
    the CLIP blocks' fused sub-blocks off (`fused`), the attention modules
    of the ImageNet ViT family and the head-major route on "xla"
    (`implementation`).  The same function, computed by aten operations."""
    saved = []
    for mod in model.modules():
        if getattr(mod, "fused", None) is True:
            saved.append((mod, "fused", True))
            mod.fused = False
        if getattr(mod, "implementation", None) == "pallas":
            saved.append((mod, "implementation", "pallas"))
            mod.implementation = "xla"
    try:
        yield model
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _int_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """torch._int_mm (M, K) x (K, N): 2 M K N, as a float product counts."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def model_flops(model: torch.nn.Module, images: torch.Tensor, cams: torch.Tensor,
                train: bool = False) -> Dict[str, Any]:
    """The operations of one forward of the embedding: {"flops",
    "bytes_accessed"}, as the JAX package's XLA cost model returns them.

    FlopCounterMode counts the matrix products, convolutions and attention
    calls that reach aten (2 per multiply-add; TPU.INT8_MLP's torch._int_mm
    counted as a product too).  The hand-written kernels run outside aten,
    behind ctypes, where it sees nothing, so the forward is counted through
    the plain route (plain_route): the same function, the kernels' work
    included as the plain versions' products.  Elementwise work is not
    counted (XLA's count has it).  torch has no count of bytes moved, so
    "bytes_accessed" is 0.0.  An error of the count is raised, not reported
    as zeros.  The parameters are frozen for the call (rather than grad
    mode off, where the counter's module tracker trips over views of a
    parameter)."""
    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten._int_mm: _int_mm_flop})
    with plain_route(model), frozen_parameters(model), counter:
        model(images, cams, train=train)["embedding"]
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": 0.0}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler trace of the block (host, and the card where there is
    one), written under `log_dir` by TensorBoard's trace handler; view it
    with TensorBoard's profile plugin.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class ThroughputMeter:
    """samples/s meter matching the reference's per-epoch log format."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.time()
        self.samples = 0
        self.iters = 0

    def update(self, batch_size: int):
        self.samples += batch_size
        self.iters += 1

    def report(self) -> str:
        dt = time.time() - self.t0
        per_batch = dt / max(self.iters, 1)
        speed = self.samples / max(dt, 1e-9)
        return f"Time per batch: {per_batch:.3f}[s] Speed: {speed:.1f}[samples/s]"
