"""Flax variables of demo2_tpu -> state_dict of the port.

The inverse of demo2_tpu/utils/converters.py's layout rules (`_t`, `_conv`):
  * a Dense kernel (in, out) becomes a Linear weight (out, in);
  * `in_proj_kernel` (C, 3C) becomes `in_proj_weight` (3C, C);
  * a conv kernel HWIO becomes OIHW;
  * LayerNorm / BatchNorm `scale` becomes `weight`; batch_stats `mean` /
    `var` become the `running_mean` / `running_var` buffers;
  * cv_embed, class_embedding, positional_embedding, proj, the DGAF queries
    and alpha, and SDTPS's stacked (3, 3, C, C) q/k kernels stay as they are.
Module names map one to one, with `resblocks_3` -> `resblocks.3`,
`modal_weight_mlp_0` -> `modal_weight_mlp.0`, and TorchLinear's inner
`Dense_0` dropped.  The conversion is strict both ways: a flax leaf that
fills no port tensor, or a port tensor that no leaf fills, raises.

`convert_train_state` carries a JAX train state into the port's TrainState:
the params and batch_stats (after any number of steps) into the model, and
optax's Adam state (count, and mu / nu, trees shaped like the params) into
the optimizer, under the same rules.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_LISTS = re.compile(r"^(resblocks|modal_weight_mlp)_(\d+)$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(value)


def _module_path(parts) -> list:
    out = []
    for p in parts:
        if p == "Dense_0":
            continue
        m = _LISTS.match(p)
        out.extend(m.groups() if m else (p,))
    return out


def _leaf(collection: str, name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if collection == "batch_stats":
        return {"mean": "running_mean", "var": "running_var"}[name], value
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim} has no port layout")
    if name == "in_proj_kernel":
        return "in_proj_weight", value.T
    if name == "scale":
        return "weight", value
    return name, value


def _convert(variables: Mapping, target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    unconsumed = []
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unexpected flax collection {collection!r}")
        for path, value in _flatten(tree):
            name, arr = _leaf(collection, path[-1], value)
            key = ".".join(_module_path(path[:-1]) + [name])
            if key not in target or key in out:
                unconsumed.append("/".join((collection,) + path))
                continue
            if tuple(target[key].shape) != arr.shape:
                raise ValueError(f"{'/'.join((collection,) + path)} -> {key}: shape "
                                 f"{arr.shape} != port {tuple(target[key].shape)}")
            ref = target[key]
            arr = np.ascontiguousarray(arr, np.float32).reshape(arr.shape)  # keeps 0-d leaves 0-d
            out[key] = torch.from_numpy(arr).to(ref.device, ref.dtype)
    missing = sorted(set(target) - set(out))
    if unconsumed or missing:
        raise ValueError(f"flax leaves with no port tensor: {unconsumed}; "
                         f"port tensors no leaf filled: {missing}")
    return out


def convert_flax_variables(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """`variables` is the flax {"params", "batch_stats"} tree of `model`'s JAX
    counterpart, as nested dicts of arrays; returns a full state_dict for
    `model.load_state_dict`, on the model's devices and dtypes."""
    return _convert(variables, model.state_dict())


def _adam_state(opt_state):
    """The ScaleByAdamState inside an optax chain's state, or None."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if hasattr(opt_state, "inner_state"):
        return _adam_state(opt_state.inner_state)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def convert_train_state(variables: Mapping, opt_state, state) -> None:
    """Load a JAX train state's variables and Adam state into the port's
    TrainState `state` (engine/state.py), in place."""
    state.model.load_state_dict(convert_flax_variables(variables, state.model), strict=True)
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("the optax state holds no Adam state (count, mu, nu)")
    opt = state.optimizer
    moments = {}
    for slot in ("mu", "nu"):
        target = {n: st[slot] for n, st in opt.state.items()}
        moments[slot] = _convert({"params": getattr(adam, slot)}, target)
    opt.load_state_dict({"count": int(np.asarray(adam.count)),
                         "state": {n: {slot: moments[slot][n] for slot in moments}
                                   for n in opt.state}})
