"""Multi-process data parallelism: which rows each rank feeds
(demo2_tpu/parallel/multihost.py).

Every rank computes the same global PK order from the shared (seed, epoch),
takes its contiguous rows of each global batch (`host_batch_rows`, the
layout of JAX's P('data') sharding) and decodes only those; the per-sample
augmentation of a host pipe is keyed on the rows' global positions, so a
rank's rows are the one-process batch's rows.  JAX assembles the global
jax.Array from the hosts' rows; here each rank keeps its rows, and the step
reads across the batch through parallel/collectives.py.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch.distributed as dist

from .mesh import World, check_batch, group_initialized


def process_index() -> int:
    return dist.get_rank() if group_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if group_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0)."""
    return process_index() == 0


def host_batch_rows(world: World, global_batch: int) -> np.ndarray:
    """The global batch rows this rank feeds: [r B / W, (r + 1) B / W)."""
    check_batch(world, global_batch, "the global batch")
    b = global_batch // world.size
    return np.arange(world.rank * b, (world.rank + 1) * b, dtype=np.int64)


def _chunks(order: np.ndarray, batch_size: int, drop_last: bool,
            pad_last: bool) -> Iterator[Tuple[np.ndarray, int]]:
    """(global index batch, valid rows): full batches, then the remainder
    unless `drop_last`, padded with its last index to the batch with
    `pad_last`."""
    n_full = len(order) // batch_size
    for i in range(n_full):
        yield order[i * batch_size : (i + 1) * batch_size], batch_size
    rem = order[n_full * batch_size :]
    if len(rem) and not drop_last:
        valid = len(rem)
        if pad_last:
            rem = np.concatenate([rem, np.full(batch_size - valid, rem[-1], rem.dtype)])
        yield rem, valid


def iter_index_batches(world: World, order: np.ndarray, batch_size: int,
                       drop_last: bool = True,
                       pad_last: bool = False) -> Iterator[Tuple[np.ndarray, int]]:
    """(this rank's rows of each index batch of `order`, the batch's valid
    rows), for the device-cache input path.  A remainder is padded to the
    batch before it is split (`pad_last`; a world of more than one rank
    requires it for a remainder, since ranks take equal rows)."""
    order = np.asarray(order, np.int64)
    rows = host_batch_rows(world, batch_size)
    for chunk, valid in _chunks(order, batch_size, drop_last, pad_last):
        if len(chunk) < batch_size and world.size > 1:
            raise ValueError("a world of several ranks splits whole batches: pass pad_last")
        yield (chunk[rows] if world.size > 1 else chunk), valid


class HostShardedBatches:
    """A data pipe (data/loader.py) seen by one rank: each global batch of
    the pipe's batch size yields this rank's rows, decoded alone with the
    augmentation keyed on their global positions; `valid` stays the global
    batch's, and the sample list (the metadata) is the whole pipe's."""

    def __init__(self, pipe, world: World):
        self.pipe = pipe
        self.rows = host_batch_rows(world, pipe.batch_size)

    def iter_batches(self, order: np.ndarray, seed: int = 0, drop_last: bool = True,
                     pad_last: bool = False, **kw):
        """The pipe's iter_batches over `order`, this rank's rows of each
        batch (padded with `pad_last` before the split)."""
        return self.pipe.iter_batches(order, seed=seed, drop_last=drop_last, pad_last=pad_last,
                                      rows=self.rows, **kw)
