"""The data-parallel world (demo2_tpu/parallel/mesh.py).

JAX runs one program over a ('data',) device mesh: the batch is sharded over
its devices, the parameters are replicated and XLA inserts the collectives.
Here one process drives one device, and the world is the torch.distributed
process group: `make_world` gives this process's size, rank, device and the
group's backend, `join_process_group` joins the group a launcher
(`torchrun`) describes in the environment.

Differences from JAX on purpose:
  D12  JAX's make_mesh(N) takes N local devices in one process.  One
       PyTorch process drives one device, so NUM_DEVICES > 1 without a
       process group raises, naming the launch (torchrun --nproc_per_node N
       ... --distributed).

The backend: NCCL where each rank has its own card (the device defaults to
cuda:LOCAL_RANK); gloo on the CPU, or where the caller pins the device
(MODEL.DEVICE "cuda:N", or a device passed to the entry point), since then
ranks may share a card and NCCL refuses a duplicated GPU.  Gloo's
all_reduce, all_gather and broadcast take CUDA tensors, staged through the
host.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

LAUNCH = "torchrun --nproc_per_node {n} -m demo2_tpu_torch.tools.train --distributed ..."


@dataclass(frozen=True)
class World:
    """This process's place in the data-parallel world."""

    size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None  # None: no process group

    @property
    def primary(self) -> bool:
        """True on the rank that writes checkpoints, logs and the rank list."""
        return self.rank == 0


def group_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_world(num_devices: int = -1, device: Optional[torch.device] = None) -> World:
    """The world of TPU.NUM_DEVICES = `num_devices`: under a process group
    the group (N > 0 must equal its size), else one process (N <= 1; D12)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if group_initialized():
        size = dist.get_world_size()
        if num_devices > 0 and num_devices != size:
            # A world smaller than the group would leave ranks outside its
            # collectives, which then hang, as JAX's make_mesh refuses a
            # truncated mesh under several processes.
            raise ValueError(f"TPU.NUM_DEVICES={num_devices} under a process group of {size} "
                             f"ranks: set it to -1 or {size}")
        return World(size, dist.get_rank(), device, dist.get_backend())
    if num_devices > 1:
        raise ValueError(f"TPU.NUM_DEVICES={num_devices} in one process: a PyTorch process "
                         f"drives one device, so launch one process a device "
                         f"({LAUNCH.format(n=num_devices)})")
    return World(1, 0, device, None)


def check_batch(world: World, batch: int, what: str) -> None:
    """A global batch splits into equal rows per rank."""
    if batch % world.size:
        raise ValueError(f"{what}={batch} does not divide over {world.size} ranks")


def distributed_device(model_device: str, device=None,
                       local_rank: int = 0) -> Tuple[torch.device, bool]:
    """(this rank's device, pinned): the caller's `device`, the CPU for
    MODEL.DEVICE "cpu", MODEL.DEVICE "cuda:N" as given (pinned: ranks may
    share it), else cuda:LOCAL_RANK, which must exist."""
    if device is not None:
        return torch.device(device), True
    if model_device == "cpu":
        return torch.device("cpu"), True
    if model_device.startswith("cuda:"):
        return torch.device(model_device), True
    if not torch.cuda.is_available() or local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"rank with LOCAL_RANK {local_rank} has no CUDA device "
                           f"({torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                           "visible); set MODEL.DEVICE cpu to run on the CPU")
    return torch.device("cuda", local_rank), False


def join_process_group(model_device: str, device=None, local_rank: Optional[int] = None,
                       timeout_s: float = 1800.0) -> World:
    """Join the group a launcher describes (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT, LOCAL_RANK in the environment, as torchrun sets them) and
    return this rank's world: NCCL where the device is cuda:LOCAL_RANK,
    gloo where it is the CPU or pinned."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    dev, pinned = distributed_device(model_device, device, local_rank)
    backend = "gloo" if dev.type == "cpu" or pinned else "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return make_world(-1, dev)


def leave_process_group() -> None:
    if group_initialized():
        dist.destroy_process_group()
