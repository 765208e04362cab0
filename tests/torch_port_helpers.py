"""Shared helpers of the tests/test_torch_*.py parity tests (not a test module).

A flax module's variable tree is taken from `jax.eval_shape(init)`, and every
leaf is filled with seeded numpy values (no zero-initialised leaf hides a
layout mistake); the same tree then goes to the JAX module as numpy arrays
and, through the port's converter, to the port module.
"""

from __future__ import annotations

import functools
import sys
from unittest import mock

import flax
import jax
import numpy as np
import torch

from demo2_tpu.ops.packed_attention import _choose_bb
from demo2_tpu_torch.ops.packed_attention import probs_cols
from demo2_tpu_torch.utils.converters import convert_flax_variables

CPU = torch.device("cpu")


def import_tensorboard_without_tensorflow() -> None:
    """Import torch.utils.tensorboard with TensorFlow unimportable, so that
    TensorBoard's writer takes its own stub, as where TensorFlow is not
    installed (where it is, its import takes seconds a process).
    sys.modules is restored after; event files are written alike."""
    if "torch.utils.tensorboard" in sys.modules:
        return
    kept = sys.modules.get("tensorflow", False)
    sys.modules["tensorflow"] = None
    try:
        import torch.utils.tensorboard  # noqa: F401
    finally:
        if kept is False:
            del sys.modules["tensorflow"]
        else:
            sys.modules["tensorflow"] = kept


def jax_state_from(cfg, jmodel, variables, sample, steps_per_epoch: int = 4):
    """JAX's create_train_state, its model.init answered by `variables`
    (the tests start from those variables, so the init's compile of the
    whole model would be thrown away): the state holds them and the
    optimizer state JAX's chain initialises from them.  Returns what
    create_train_state returns: (state, tx, center_tx, schedule)."""
    from demo2_tpu.engine import create_train_state

    with mock.patch.object(type(jmodel), "init", lambda self, *args, **kwargs: variables):
        return create_train_state(cfg, jmodel, jax.random.PRNGKey(0), sample, steps_per_epoch)


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


def jax_to_port_probs(jprobs, b, h, s):
    """The TPU's saved probs, (H*B, S_pad, S_pad) with H*bb rows per program
    and head-major inside it, in the port's (B, H, S, S16) layout."""
    bb = _choose_bb(b, 8)
    sp = jprobs.shape[-1]
    p = np.asarray(jprobs).reshape(b // bb, h, bb, sp, sp).transpose(0, 2, 1, 3, 4)
    p = p.reshape(b, h, sp, sp)[:, :, :s, :s]
    return np.pad(p, ((0, 0), (0, 0), (0, 0), (0, probs_cols(s) - s)))


def port_to_jax_probs(probs, s_pad):
    """The port's (B, H, S, S16) probs in the TPU's layout at S_pad."""
    b, h, s, _ = probs.shape
    bb = _choose_bb(b, 8)
    p = np.zeros((b, h, s_pad, s_pad), np.float32)
    p[:, :, :s, :s] = probs[..., :s]
    p = p.reshape(b // bb, bb, h, s_pad, s_pad).transpose(0, 2, 1, 3, 4)
    return p.reshape(h * b, s_pad, s_pad)


# ---------------------------------------------------------------------------
# Module parity with batch statistics, and whole train steps, against JAX
# ---------------------------------------------------------------------------

BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -5)


def apply_train(module, variables, *args, **kwargs):
    """`module.apply` with the batch statistics mutable (a training call):
    (output, updated batch_stats)."""
    out, upd = jax.jit(functools.partial(module.apply, mutable=["batch_stats"],
                                         rngs={"dropout": jax.random.PRNGKey(0)}, **kwargs))(
        variables, *args)
    return out, upd.get("batch_stats")


def check_stats(port, variables, updated, tol) -> None:
    """The port's BatchNorm buffers after a training forward against the
    batch_stats JAX returned; each must have moved."""
    want = convert_flax_variables({"params": variables["params"], "batch_stats": updated}, port)
    before = convert_flax_variables(variables, port)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    sd = port.state_dict()
    for k in stats:
        assert not np.array_equal(n(sd[k]), n(before[k])), k
        np.testing.assert_allclose(n(sd[k]), n(want[k]), err_msg=k, **tol)


def assert_bf16_as_close_as_jax(got, want_bf16, ref_f32) -> None:
    """A bf16 result held against the f32 forward of the same weights: the
    port no further from it than the JAX package's bf16 result (batch
    statistics over few samples magnify bf16 rounding, which the two round
    at other points), and elementwise within the bf16 tolerance of JAX's
    but for a handful of elements."""
    got, want, ref = n(got), np.asarray(want_bf16, np.float32), np.asarray(ref_f32, np.float32)
    err, jerr = np.abs(got - ref), np.abs(want - ref)
    assert err.mean() <= 1.25 * jerr.mean() + 1e-6 and err.max() <= 2 * jerr.max() + 1e-6, (
        err.mean(), jerr.mean(), err.max(), jerr.max())
    far = np.abs(got - want) > BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(want)
    assert far.mean() < 1e-2, far.mean()


def jax_train_case(cfg, num_classes: int, camera_num: int, seed: int = 8, batch: int = 16):
    """One whole f32 train step of `cfg`'s JAX model from random variables:
    a dict of the inputs, the variables, the loss with its auxiliary losses
    (LIF_LOSS_WEIGHT on 'lif'), the aux values, the gradients, the state
    after JAX's build_train_step and its metrics.  Callers turn flax's
    dropout off."""
    import types

    import jax.numpy as jnp
    from demo2_tpu.engine.train import build_train_step as j_build_train_step
    from demo2_tpu.losses import losses as jl
    from demo2_tpu.models import make_model as j_make_model

    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, 3, h, w, 3)).astype(np.float32)
    pids = np.repeat(np.arange(batch // 2), 2).astype(np.int32)
    cams = rng.integers(0, camera_num, batch).astype(np.int32)
    jmodel = j_make_model(cfg, num_classes, camera_num)
    variables = random_variables(jmodel, images[:2], cams[:2], train=False, seed=seed)
    sample = types.SimpleNamespace(images=images[:2], camids=cams[:2], viewids=cams[:2] * 0)
    jstate, tx, ctx, _ = jax_state_from(cfg, jmodel, variables, sample)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
    jargs = (jnp.asarray(images), jnp.asarray(pids), jnp.asarray(cams), jnp.asarray(cams * 0))
    loss_fn = jl.make_loss_fn(cfg, num_classes)

    def j_loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jargs[0], jargs[2], jargs[3], None, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0),
                                    "gumbel": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        wts = jl.branch_weights(cfg, out["branches"].keys())
        total = sum(wts[k] * loss_fn(lg, f, jargs[1]) for k, (lg, f) in out["branches"].items())
        for name, value in out["aux_loss"].items():
            total = total + (cfg.MODEL.LIF_LOSS_WEIGHT if name == "lif" else 1.0) * value
        return total, out["aux_loss"]

    (loss, aux), grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(variables["params"])
    new_jstate, metrics = j_build_train_step(cfg, jmodel, tx, ctx, donate=False)(
        jstate, *jargs, jax.random.PRNGKey(1))
    return dict(images=images, pids=pids, cams=cams, variables=variables, loss=float(loss),
                aux={k: float(v) for k, v in aux.items()}, grads=grads, state=new_jstate,
                metrics=metrics)


def check_train_step(cfg, port, case, num_classes: int) -> dict:
    """The port's training forward, loss and gradients against `case`
    (jax_train_case), then the BatchNorm statistics its forward updated
    against those of JAX's step.  Returns the port's gradients."""
    from demo2_tpu_torch.engine.train import loss_and_grads
    from demo2_tpu_torch.losses import losses as tl

    np.testing.assert_allclose(float(case["metrics"]["loss"]), case["loss"], rtol=1e-6)
    variables = case["variables"]
    images, pids, cams = t(case["images"]), t(case["pids"]).long(), t(case["cams"]).long()
    if case["aux"]:
        with torch.no_grad():
            aux = port(images, cams, None, None, train=True)["aux_loss"]
        assert sorted(aux) == sorted(case["aux"])
        for k, v in case["aux"].items():
            np.testing.assert_allclose(n(aux[k]), v, rtol=1e-5, err_msg=k)
        port.load_state_dict(convert_flax_variables(variables, port))  # undo the stats update
    loss, acc, grads = loss_and_grads(cfg, port, tl.make_loss_fn(cfg, num_classes), images,
                                      pids, cams, None)
    np.testing.assert_allclose(n(loss), case["loss"], rtol=1e-5)
    np.testing.assert_allclose(n(acc), float(case["metrics"]["acc"]))
    want = convert_flax_variables({"params": case["grads"],
                                   "batch_stats": variables["batch_stats"]}, port)
    assert set(grads) == {k for k, _ in port.named_parameters()}
    # Per tensor: 1e-4 of its largest element, and 1e-6 of the model's largest
    # (some grads are zero up to f32 noise, e.g. a bias the BNNeck cancels).
    top = max(np.abs(n(want[k])).max() for k in grads)
    for k, g in grads.items():
        wk = n(want[k])
        np.testing.assert_allclose(n(g), wk, rtol=1e-3, atol=1e-4 * np.abs(wk).max() + 1e-6 * top,
                                   err_msg=k)
    stats = convert_flax_variables({"params": case["state"].params,
                                    "batch_stats": case["state"].batch_stats}, port)
    before = convert_flax_variables(variables, port)
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert not np.array_equal(n(v), n(before[k])), k
            np.testing.assert_allclose(n(v), n(stats[k]), err_msg=k, rtol=1e-5, atol=1e-5)
    return grads

# ---------------------------------------------------------------------------
# f32 results held against an f64 run of the port (the CNN trunks)
# ---------------------------------------------------------------------------

# The CNN maps pass 50 convolutions and BatchNorms.  In training the
# BatchNorms normalise by the statistics of few values (16 a channel in
# layer4 at batch 2), whose fast variance E[x^2] - E[x]^2 magnifies the
# summation order's noise: JAX's own f32 map lies up to 3.2e-4 of its
# largest value from an f64 run of the port.  There the port is held to 1e-3
# of it, and about as far from the f64 run as JAX's f32 map is.
TRAIN_REL = 1e-3


def close_to_scale(got, want, rel=1e-4):
    """Elementwise within `rel` of the largest |value| of `want`."""
    want = np.asarray(want)
    np.testing.assert_allclose(n(got), want, rtol=rel, atol=rel * np.abs(want).max())


def as_f64(module):
    """The module with f64 parameters, buffers and compute dtype."""
    module = module.double()
    for m in module.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return module


def as_close_as_jax(got, want, ref):
    """Within TRAIN_REL of the largest |value| of JAX's f32 result, and about
    as far from the f64 result `ref` as JAX's is: by the mean, at most twice
    as far plus 1e-7 of the largest value (oneDNN's and XLA's f32
    convolutions sum in other orders; at eval both lie ~2e-7 of it away)."""
    want = np.asarray(want)
    close_to_scale(got, want, TRAIN_REL)
    assert np.abs(n(got) - ref).mean() <= (2 * np.abs(want - ref).mean()
                                           + 1e-7 * np.abs(ref).max())
