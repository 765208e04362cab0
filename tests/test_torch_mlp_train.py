"""The port's fused MLP in training (TPU.FUSED_MLP_TRAIN) against the JAX
package on the CPU.

On the CPU the wrapper of kernel 2's training form takes its plain PyTorch
version; that is held here against the Pallas kernel `_mlp_kernel`, run in
interpret mode as tests/test_pallas_kernels.py runs it, for the output and
for the pre-GELU hidden h.  FusedMlpBlockFn is held against jax.vjp of
`fused_mlp_block(..., interpret=True)`, which runs `_fused_mlp_bwd`.  One
whole f32 train step of the tiny flagship with the flag on is held against
JAX's `build_train_step` under the same flag.  There the JAX model calls
`fused_mlp_block` without `interpret`, which off the TPU routes to
`_mlp_reference_impl` and autodiff of it (fused_block.py:506), as JAX's own
CPU tests of the model take it; the custom VJP itself is what the second
group of tests here holds.
"""

import functools
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.engine.train import build_train_step as j_build_train_step
from demo2_tpu.losses import losses as jl
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.ops.fused_block import _fused_mlp_fwd_impl, fused_mlp_block
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.engine.train import loss_and_grads
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.ops import fused_block as fb
from demo2_tpu_torch.utils.converters import convert_flax_variables
from torch_port_helpers import CPU, generator, jax_state_from, load_port, n, random_variables, t

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)  # as test_fused_mlp_block_grad_matches_unfused
NAMES = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")


def _mlp_inputs(seed, b=2, s=9, c=32, f=128):
    """The inputs of test_fused_mlp_block_grad_matches_unfused, in the flax
    layouts w1 (C, F), w2 (F, C), and a cotangent at 0.3."""
    rng = np.random.default_rng(seed)
    r = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    return (r(b, s, c), np.full(c, 0.9, np.float32), np.full(c, -0.02, np.float32),
            r(c, f, std=0.1), r(f, std=0.1), r(f, c, std=0.1), r(c, std=0.1)), r(b, s, c, std=0.3)


def _port_args(args, dtype=torch.float32):
    x, lns, lnb, w1, b1, w2, b2 = args
    return [t(x).to(dtype), t(lns), t(lnb), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2)]


# ---------------------------------------------------------------------------
# Kernel 2's training form: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [(2, 9), (3, 8)], ids=["ragged_rows", "whole_blocks"])
def test_training_forward_plain_matches_pallas_kernel_f32(rows):
    args, _ = _mlp_inputs(seed=sum(rows), b=rows[0], s=rows[1])
    want_out, want_h = _fused_mlp_fwd_impl(*(jnp.asarray(a) for a in args), 8, True)
    out, h = fb.fused_mlp_block_train(*_port_args(args))
    assert out.shape == args[0].shape and h.shape == (rows[0] * rows[1], 128)
    np.testing.assert_allclose(n(out), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(n(h), np.asarray(want_h), **TOL)
    # the eval form is the same function without h
    np.testing.assert_allclose(n(fb.fused_mlp_block(*_port_args(args))), n(out), **TOL)


def test_training_forward_plain_rounds_where_the_pallas_kernel_rounds_bf16():
    args, _ = _mlp_inputs(seed=5)
    jargs = [jnp.asarray(args[0], jnp.bfloat16)] + [jnp.asarray(a) for a in args[1:]]
    want_out, want_h = _fused_mlp_fwd_impl(*jargs, 8, True)
    pargs = _port_args(args, torch.bfloat16)
    pargs[3], pargs[5] = pargs[3].to(torch.bfloat16), pargs[5].to(torch.bfloat16)
    out, h = fb.fused_mlp_block_train(*pargs)
    assert out.dtype == h.dtype == torch.bfloat16 and want_h.dtype == jnp.bfloat16
    # h and out are rounded once on both sides, from f32 sums taken in another
    # order: two bf16 ulps of the value.
    for name, got, want in (("h", h, want_h), ("out", out, want_out)):
        want = np.asarray(want, np.float32)
        assert (np.abs(n(got) - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), name


def test_hidden_is_rounded_from_f32_and_gelu_taken_from_the_f32_hidden():
    """g comes from the f32 h, not from the rounded one: recomputing the
    output from the returned bf16 h gives another (less exact) result."""
    args, _ = _mlp_inputs(seed=6, b=4, s=16)
    pargs = _port_args(args, torch.bfloat16)
    out, h = fb.mlp_block_train_plain(*pargs)
    x, _, _, _, _, w2, b2 = pargs
    hf = h.float()
    g = (hf * torch.sigmoid(1.702 * hf)).to(torch.bfloat16)
    y = g.float() @ w2.to(torch.bfloat16).float().t() + b2
    from_rounded = (x.float() + y.reshape(x.shape)).to(torch.bfloat16)
    assert not torch.equal(from_rounded, out)
    np.testing.assert_allclose(n(from_rounded), n(out), rtol=0, atol=0.05)


# ---------------------------------------------------------------------------
# FusedMlpBlockFn against _fused_mlp's custom VJP
# ---------------------------------------------------------------------------


def _fn_grads(pargs, g, requires=(True,) * 7):
    leaves = [a.clone().requires_grad_(r) for a, r in zip(pargs, requires)]
    y = fb.fused_mlp(*leaves)
    y.backward(t(g).to(y.dtype))
    return y, [v.grad for v in leaves]


def test_function_grads_match_the_custom_vjp_in_interpret_mode():
    args, g = _mlp_inputs(seed=7)
    want_out, vjp = jax.vjp(lambda *a: fused_mlp_block(*a, block_rows=8, interpret=True),
                            *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    y, got = _fn_grads(_port_args(args), g)
    assert type(y.grad_fn).__name__ == "FusedMlpBlockFnBackward"
    np.testing.assert_allclose(n(y), np.asarray(want_out), **TOL)
    got = [n(v) for v in got]
    got[3], got[5] = got[3].T, got[5].T  # back to the flax (in, out) layout
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(w), err_msg=name, **GRAD_TOL)


def test_function_saves_x_and_the_hidden_in_the_compute_dtype():
    args, g = _mlp_inputs(seed=8)
    pargs = _port_args(args, torch.bfloat16)
    saved = fb.fused_mlp(pargs[0].clone().requires_grad_(True), *pargs[1:]).grad_fn.saved_tensors
    _, grads = _fn_grads(pargs, g)
    assert [tuple(v.shape) for v in saved[:2]] == [(2, 9, 32), (18, 128)]
    assert saved[1].dtype == torch.bfloat16
    assert all(tuple(v.shape) != (18, 32) or v.dtype != torch.bfloat16 for v in saved[2:]), \
        "LN(x) is recomputed, not saved"
    assert grads[0].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in grads[1:])


def test_bf16_backward_reads_the_saved_hidden_not_a_recomputed_one(monkeypatch):
    """With the forward's h swapped for zeros the backward must follow: the
    GELU of 0 is 0, so dW2 vanishes, and its derivative is 1/2, so dh = dg / 2."""
    args, g = _mlp_inputs(seed=9)
    pargs = _port_args(args, torch.bfloat16)
    real = fb.fused_mlp_block_train

    def zero_hidden(*a):
        out, h = real(*a)
        return out, torch.zeros_like(h)

    monkeypatch.setattr(fb, "fused_mlp_block_train", zero_hidden)
    _, grads = _fn_grads(pargs, g)
    assert not grads[5].any()
    dy = t(g).to(torch.bfloat16).reshape(-1, 32)
    dh = ((dy @ pargs[5].to(torch.bfloat16)).float() * 0.5).to(torch.bfloat16)
    np.testing.assert_array_equal(n(grads[4]), n(dh.float().sum(0)))


def test_bf16_function_grads_are_close_to_the_f32_grads():
    args, g = _mlp_inputs(seed=10, b=4, s=16)
    _, want = _fn_grads(_port_args(args), g)
    _, got = _fn_grads(_port_args(args, torch.bfloat16), g)
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(n(a), n(w), rtol=0, atol=3e-2 * w.abs().max().item(),
                                   err_msg=name)


@pytest.mark.parametrize("requires", [
    (True, False, False, False, False, False, False),
    (False, True, True, True, True, True, True),
    (False, False, False, False, False, True, True),
    (False, False, False, True, False, False, False),
], ids=["input_only", "parameters_only", "fc2_only", "w1_only"])
def test_function_computes_only_the_grads_asked_for(requires):
    args, g = _mlp_inputs(seed=11)
    _, full = _fn_grads(_port_args(args), g)
    _, part = _fn_grads(_port_args(args), g, requires)
    for name, r, a, w in zip(NAMES, requires, part, full):
        assert (a is not None) == r, name
        if r:
            assert torch.equal(a, w), name


def test_fused_mlp_chooses_the_eval_kernel_without_grad(monkeypatch):
    args, _ = _mlp_inputs(seed=12)
    pargs = [a.requires_grad_(True) for a in _port_args(args)]
    calls = []
    real = fb.fused_mlp_block_train
    monkeypatch.setattr(fb, "fused_mlp_block_train",
                        lambda *a: calls.append("train") or real(*a))
    with torch.no_grad():
        y = fb.fused_mlp(*pargs)
    assert y.grad_fn is None and calls == []
    fb.fused_mlp(*pargs)
    assert calls == ["train"]


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    args, _ = _mlp_inputs(seed=0)
    meta = [a.to("meta") for a in _port_args(args)]
    for fn in (fb.fused_mlp_block_train, fb.fused_mlp_block):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*meta)


def test_wrapper_counts_no_launch_on_the_cpu():
    before = fb.fused_mlp_block_train.launches
    args, _ = _mlp_inputs(seed=0)
    fb.fused_mlp_block_train(*_port_args(args))
    assert fb.fused_mlp_block_train.launches == before


# ---------------------------------------------------------------------------
# The flag through the model
# ---------------------------------------------------------------------------

NUM_CLASSES, CAMERA_NUM = 8, 4


def _cfg(flag: bool = True, flash: bool = True):
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.TPU.USE_FLASH_ATTENTION = flash
    cfg.TPU.FUSED_MLP_TRAIN = flag
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SOLVER.BASE_LR = 3.5e-4
    return cfg


@pytest.mark.parametrize("flag,flash,train,want", [
    (True, True, True, "fused"), (False, True, True, "unfused"), (True, True, False, "fused"),
    (False, True, False, "fused"), (True, False, True, "unfused"),
], ids=["flag_train", "default_train", "flag_eval", "default_eval", "unfused_attention"])
def test_flag_selects_the_mlp_jax_selects(flag, flash, train, want, monkeypatch):
    """clip_vit.py:250: the fused MLP runs where `fused and (not train or
    fused_mlp_train)`."""
    from demo2_tpu_torch.models import clip_vit

    model = make_model(_cfg(flag, flash), NUM_CLASSES, CAMERA_NUM, device=CPU,
                       generator=generator())
    assert all(blk.fused_mlp_train == flag for blk in model.backbone.base.resblocks)
    calls = []
    real = clip_vit.fused_mlp
    monkeypatch.setattr(clip_vit, "fused_mlp", lambda *a: calls.append("fused") or real(*a))
    h, w = _cfg().INPUT.SIZE_TRAIN
    images = torch.zeros(2, 3, h, w, 3)
    with torch.set_grad_enabled(train):
        model.train(train)(images, torch.zeros(2, dtype=torch.long), train=train)
    depth = len(model.backbone.base.resblocks)
    assert calls == (["fused"] * depth if want == "fused" else [])


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


@functools.cache
def _jax_step():
    """JAX's train step of the tiny flagship with FUSED_MLP_TRAIN: (cfg,
    inputs, variables, loss, grads, state after the step).  Callers turn
    flax's dropout off."""
    cfg = _cfg()
    cfg.freeze()
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(21)
    images = rng.standard_normal((16, 3, h, w, 3)).astype(np.float32)
    pids = np.repeat(np.arange(8), 2).astype(np.int32)
    cams = rng.integers(0, CAMERA_NUM, 16).astype(np.int32)
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, images[:2], cams[:2], train=False, seed=21)
    batch = types.SimpleNamespace(images=images[:2], camids=cams[:2], viewids=cams[:2] * 0)
    jstate, tx, ctx, _ = jax_state_from(cfg, jmodel, variables, batch)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
    jargs = (jnp.asarray(images), jnp.asarray(pids), jnp.asarray(cams), jnp.asarray(cams * 0))
    loss_fn = jl.make_loss_fn(cfg, NUM_CLASSES)

    def j_loss(params):  # the loss as JAX's train step takes it
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jargs[0], jargs[2], jargs[3], None, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        wts = jl.branch_weights(cfg, out["branches"].keys())
        return sum(wts[k] * loss_fn(lg, f, jargs[1]) for k, (lg, f) in out["branches"].items())

    j_loss_value, j_grads = jax.jit(jax.value_and_grad(j_loss))(variables["params"])
    new_jstate, metrics = j_build_train_step(cfg, jmodel, tx, ctx, donate=False)(
        jstate, *jargs, jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss_value), rtol=1e-6)
    return cfg, (images, pids, cams), variables, float(j_loss_value), j_grads, new_jstate


def test_one_train_step_with_the_flag_matches_jax(no_flax_dropout, monkeypatch):
    cfg, (images, pids, cams), variables, j_loss, j_grads, new_jstate = _jax_step()
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator()),
                     variables)
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    calls = []
    real = fb.fused_mlp_block_train
    monkeypatch.setattr(fb, "fused_mlp_block_train",
                        lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    loss, _, grads = loss_and_grads(cfg, port, tl.make_loss_fn(cfg, NUM_CLASSES), t(images),
                                    t(pids).long(), t(cams).long(), None)
    base = port.backbone.base
    # every block's MLP went through the training form, over the stacked 3B batch
    assert calls == [(3 * 16, base.positional_embedding.shape[0], base.width)] * len(base.resblocks)
    np.testing.assert_allclose(n(loss), j_loss, rtol=1e-5)
    want_grads = convert_flax_variables({"params": j_grads,
                                         "batch_stats": variables["batch_stats"]}, port)
    assert set(grads) == {k for k, _ in port.named_parameters()}
    # As tests/test_torch_train.py holds the default route: per tensor 1e-4 of
    # its largest element, and 1e-6 of the model's largest.
    top = max(np.abs(n(want_grads[k])).max() for k in grads)
    for k, g in grads.items():
        w = n(want_grads[k])
        np.testing.assert_allclose(n(g), w, rtol=1e-3, atol=1e-4 * np.abs(w).max() + 1e-6 * top,
                                   err_msg=k)
    state = create_train_state(cfg, port, 4)
    state.optimizer.step(grads)
    want = convert_flax_variables({"params": new_jstate.params,
                                   "batch_stats": new_jstate.batch_stats}, port)
    # Adam's first step moves a weight by about lr * sign(g): where the
    # gradient stands clear of summation noise the parameters agree to 1e-6;
    # where it is zero up to noise each side may move by up to lr.  The
    # BatchNorm statistics are among the keys.
    lr = state.schedule(0)
    for k, v in port.state_dict().items():
        d = np.abs(n(v) - n(want[k]))
        assert d.max() <= 2 * lr + 1e-6, k
        if k in grads:
            w = np.abs(n(want_grads[k]))
            d = d[w > 1e-3 * w.max() + 1e-6 * top]
        assert d.size == 0 or d.max() <= 1e-6, (k, d.max())
