"""Shared helpers of the tests/test_torch_*.py parity tests (not a test module).

A flax module's variable tree is taken from `jax.eval_shape(init)`, and every
leaf is filled with seeded numpy values (no zero-initialised leaf hides a
layout mistake); the same tree then goes to the JAX module as numpy arrays
and, through the port's converter, to the port module.
"""

from __future__ import annotations

import functools

import flax
import jax
import numpy as np
import torch

from demo2_tpu_torch.utils.converters import convert_flax_variables

CPU = torch.device("cpu")


def generator(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def random_leaf(path, shape, rng: np.random.Generator) -> np.ndarray:
    name = path[-1]
    if name == "var":
        a = rng.uniform(0.5, 1.5, shape)
    elif name == "scale":
        a = 1.0 + 0.1 * rng.standard_normal(shape)
    elif len(shape) >= 2:
        fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 and name == "kernel" else shape[-2]
        a = rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))
    else:
        a = 0.1 * rng.standard_normal(shape)
    return np.asarray(a, np.float32)


def random_variables(module, *args, seed: int = 0, **kwargs):
    """The flax variable tree of `module` for these inputs, every leaf random."""
    init = functools.partial(module.init, **kwargs)
    shapes = jax.eval_shape(init, {"params": jax.random.PRNGKey(0)}, *args)
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(shapes))
    return flax.traverse_util.unflatten_dict(
        {k: random_leaf(k, tuple(v.shape), rng) for k, v in flat.items()}
    )


def apply_jit(module, variables, *args, **kwargs):
    """`module.apply` compiled once: faster than op-by-op dispatch on the CPU."""
    return jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)


def load_port(port_module: torch.nn.Module, variables) -> torch.nn.Module:
    port_module.load_state_dict(convert_flax_variables(variables, port_module), strict=True)
    return port_module.eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def n(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
