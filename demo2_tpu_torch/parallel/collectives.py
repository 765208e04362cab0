"""The collectives of data-parallel training.  JAX has no counterpart: under
its ('data',) sharding XLA inserts them.  Here each rank runs only its own
rows of the global batch, and the step calls these where the one-process
step reads across the batch, so that a step of W ranks computes the
one-process step on the same global batch:

  gather_rows     what the loss reads (logits, features, pids, a per-row
                  auxiliary term): every rank sees the global (B, ...)
                  tensor, its own slot the local tensor carrying the
                  gradient, the other slots constants.  Every rank computes
                  the global loss; its backward reaches its own rows only,
                  so the parameters' gradients are summed over the ranks.
  sum_over_ranks  BatchNorm's statistics: a sum whose backward all-reduces
                  its gradient, since rank s's rows move rank r's outputs
                  through the statistics.
  all_reduce_sum_ the step's f32 gradients, one collective over one flat
                  buffer.
  batch_rand / batch_randn / batch_randint
                  a random draw over the batch axis: the one-process draw at
                  the global shape, sliced to this rank's rows, so that every
                  row gets the draw the one-process step gives it and the
                  generator advances as it does there.

Only all_reduce, all_gather and broadcast are used: gloo takes them on CPU
and CUDA tensors, so one code path serves the CPU tests, ranks that share a
card, and NCCL.  The step enters `data_parallel(shard)` around its forward
and backward; outside it (and in a world of one) every function here is the
one-process operation, bit for bit.  The shard is a module-level setting,
not a context variable, because autograd runs a CUDA backward on a thread
of its own.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import World


@dataclass(frozen=True)
class Shard:
    """This rank's rows [lo, hi) of a global batch of `global_batch` rows:
    contiguous, rank r taking [r B / W, (r + 1) B / W), as JAX's P('data')
    sharding lays them out."""

    world: World
    global_batch: int

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.world.size

    @property
    def lo(self) -> int:
        return self.world.rank * self.local_batch

    @property
    def hi(self) -> int:
        return self.lo + self.local_batch


_ACTIVE: Optional[Shard] = None


@contextmanager
def data_parallel(shard: Optional[Shard]) -> Iterator[None]:
    """Make `shard` the active one (None, or a world of one: none) for the
    step's forward and backward; the previous one is restored on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = shard if shard is not None and shard.world.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active_shard() -> Optional[Shard]:
    return _ACTIVE


def _gather(x: torch.Tensor, world_size: int) -> List[torch.Tensor]:
    """all_gather of x from every rank, in rank order; bf16 (which gloo does
    not take) goes through f32, exactly."""
    wide = x.float() if x.dtype == torch.bfloat16 else x
    parts = [torch.empty_like(wide) for _ in range(world_size)]
    dist.all_gather(parts, wide.contiguous())
    return [p.to(x.dtype) for p in parts]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global (B, ...) tensor of this rank's (B / W, ...) rows: its own
    slot is `x` (the gradient reaches it), the others are constants."""
    s = _ACTIVE
    if s is None:
        return x
    parts = _gather(x.detach(), s.world.size)
    parts[s.world.rank] = x
    return torch.cat(parts)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """A global (B, ...) tensor whose gradient reaches this rank's rows only:
    the other rows detached.  Where a term of the global loss reads a
    parameter beside the gathered rows (the center loss's centers), each
    rank then takes its rows' share of the gradient, which the sum over
    ranks adds up."""
    s = _ACTIVE
    if s is None:
        return x
    return torch.cat([x[: s.lo].detach(), x[s.lo : s.hi], x[s.hi :].detach()])


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean() over the global batch (x's rows on axis 0)."""
    s = _ACTIVE
    if s is None:
        return x.mean()
    per_row = gather_rows(x.reshape(x.shape[0], -1).sum(1))
    return per_row.sum() / (x.numel() * s.world.size)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # Each rank's g holds its own rows' share of the loss's gradient.
        g = g.clone()
        dist.all_reduce(g)
        return g


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks of the active shard, on every rank; its
    backward is the sum of the ranks' gradients."""
    return x if _ACTIVE is None else _SumOverRanks.apply(x)


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum f32 `tensors` over the ranks in place: one all_reduce of one flat
    buffer."""
    if not tensors:
        return
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("all_reduce_sum_ takes f32 tensors")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def _batch_draw(draw: Callable, shape, batch_axis: int) -> torch.Tensor:
    """draw(shape), or under a shard the one-process draw at the global
    shape sliced to this rank's rows.  shape[batch_axis] is the local batch
    b, or k b for k blocks of the batch laid one after another (the
    backbone's modality-major 3B rows)."""
    shape = tuple(shape)
    s = _ACTIVE
    if s is None:
        return draw(shape)
    n, b = shape[batch_axis], s.local_batch
    if n % b:
        raise ValueError(f"a draw of shape {shape} has {n} rows on axis {batch_axis}, not a "
                         f"multiple of the local batch {b}")
    full = shape[:batch_axis] + (n // b, s.global_batch) + shape[batch_axis + 1:]
    return draw(full).narrow(batch_axis + 1, s.lo, b).reshape(shape)


def batch_rand(shape, *, generator, device, batch_axis: int = 0) -> torch.Tensor:
    """torch.rand(shape) of the one-process step, at this rank's rows."""
    return _batch_draw(lambda sh: torch.rand(sh, generator=generator, device=device), shape,
                       batch_axis)


def batch_randn(shape, *, generator, device, batch_axis: int = 0) -> torch.Tensor:
    """torch.randn(shape) of the one-process step, at this rank's rows."""
    return _batch_draw(lambda sh: torch.randn(sh, generator=generator, device=device), shape,
                       batch_axis)


def batch_randint(low: int, high: int, shape, *, generator, device,
                  batch_axis: int = 0) -> torch.Tensor:
    """torch.randint(low, high, shape) of the one-process step, at this
    rank's rows."""
    return _batch_draw(
        lambda sh: torch.randint(low, high, sh, generator=generator, device=device), shape,
        batch_axis)


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().reshape(-1)
    if t.is_floating_point():
        t = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[t.element_size()])
    return t.long()


def checksums(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(len(tensors),) int64: per tensor, the sum of its bit patterns
    weighted by position (wrapping), so equal tensors give equal sums and a
    changed or moved element almost surely not."""
    out = []
    for t in tensors.values():
        b = _bits(t)
        w = torch.arange(b.numel(), device=b.device) % 65521 + 1
        out.append((b * w).sum())
    return torch.stack(out) if out else torch.zeros(0, dtype=torch.long)


def check_replicas_equal(world: World, tensors: Dict[str, torch.Tensor], what: str) -> None:
    """Raise unless every rank holds bitwise the same `tensors` (the same
    names): rank 0's checksums are broadcast and compared on every rank."""
    if world.size == 1:
        return
    mine = checksums(tensors).to(world.device)
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)
    same = torch.tensor([int(torch.equal(mine, theirs))], device=world.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    if not same.item():
        names = list(tensors)
        bad = [names[i] for i in torch.nonzero(mine != theirs).flatten().tolist()]
        raise RuntimeError(f"{what} differ between the ranks (rank {world.rank} against rank 0: "
                           f"{bad[:5] or 'on another rank'})")
