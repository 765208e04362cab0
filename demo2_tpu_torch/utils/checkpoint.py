"""Checkpoints of a TrainState as torch state_dicts (demo2_tpu/utils/
checkpoint.py): the step, the model's parameters and BatchNorm statistics and
the optimizer's state, so that a resumed do_train starts at the right epoch.
The last three checkpoints of a directory are kept, as the JAX package's
orbax manager keeps them."""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

KEEP = 3
_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: Path):
    return sorted(int(m.group(1)) for p in directory.glob("step_*.pt")
                  if (m := _NAME.match(p.name)))


def save_checkpoint(directory: str, state) -> Path:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"step_{state.step}.pt"
    tmp = d / f".{path.name}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)  # a crash mid-save leaves the previous checkpoints whole
    for old in _steps(d)[:-KEEP]:
        (d / f"step_{old}.pt").unlink()
    return path


def restore_checkpoint(directory: str, state, step: Optional[int] = None):
    """Load the checkpoint at `step` (default: the latest) into `state`."""
    d = Path(directory)
    steps = _steps(d)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"No checkpoint found in {directory}")
        step = steps[-1]
    sd = torch.load(d / f"step_{step}.pt", map_location="cpu", weights_only=True)
    state.load_state_dict(sd)
    return state
