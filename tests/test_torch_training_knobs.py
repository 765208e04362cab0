"""The training knobs the port once refused, against the JAX package on the
CPU: center loss (its loss, its centers carried across, their SGD and
checkpoint), batch-hard triplet with normalized features, the warmup-linear
and timm cosine LR rules (their tables bit for bit), REMAT_BACKBONE (remat
against no remat on the CLIP and the ImageNet ViT, with drop path), and two
whole f32 train steps of the tiny flagship with all three knobs on against
JAX's build_train_step.  Inputs are made by numpy from a seed; f32 on both
sides, TOL unless a test says otherwise."""

import functools
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.engine.train import build_train_step as j_build_train_step
from demo2_tpu.losses import losses as jl
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.solver import optim as jopt
import demo2_tpu_torch.config as tcfg
import demo2_tpu_torch.config.presets as tpresets
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.engine.train import CENTERS, build_host_train_step, loss_and_grads
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.models import make_model, vit as tvit
from demo2_tpu_torch.solver import optim as topt
from demo2_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from demo2_tpu_torch.utils.converters import convert_flax_variables, convert_train_state
from torch_port_helpers import CPU, generator, jax_state_from, load_port, n, random_variables, t

TOL = dict(rtol=1e-5, atol=1e-6)
NUM_CLASSES, CAMERA_NUM = 8, 4


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_center_loss_matches_jax():
    """The loss and its gradients with respect to the centers and the features."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((NUM_CLASSES, 48)).astype(np.float32)
    feat = rng.standard_normal((16, 48)).astype(np.float32)
    labels = np.repeat(np.arange(8), 2)
    cot = 1.7
    want, (jgc, jgf) = jax.value_and_grad(
        lambda c, f: cot * jl.center_loss(c, f, jnp.asarray(labels)), argnums=(0, 1))(
        jnp.asarray(centers), jnp.asarray(feat))
    tc, tf = t(centers).requires_grad_(), t(feat).requires_grad_()
    got = cot * tl.center_loss(tc, tf, t(labels))
    gc, gf = torch.autograd.grad(got, (tc, tf))
    np.testing.assert_allclose(n(got), float(want), **TOL)
    np.testing.assert_allclose(n(gc), np.asarray(jgc), **TOL)
    np.testing.assert_allclose(n(gf), np.asarray(jgf), **TOL)
    assert not np.any(n(gc)[len(np.unique(labels)):])  # classes outside the batch: no gradient


@pytest.mark.parametrize("margin", [None, 0.3])
def test_triplet_with_normalized_features_matches_jax_and_is_finite_at_zero(margin):
    """normalize_feature=True with one all-zero feature row: the loss equals
    JAX's, the gradient is finite, and on every other row it equals JAX's.
    JAX's own gradient of the zero row is NaN: its guard max(|x|^2, 1e-60)
    rounds 1e-60 to 0 in f32 (the port's guard is f32's smallest normal)."""
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((16, 24)).astype(np.float32)
    feat[5] = 0.0
    labels = np.repeat(np.arange(8), 2)
    want, jg = jax.value_and_grad(lambda f: jl.batch_hard_triplet_loss(
        f, jnp.asarray(labels), margin=margin, normalize_feature=True))(jnp.asarray(feat))
    tf = t(feat).requires_grad_()
    got = tl.batch_hard_triplet_loss(tf, t(labels), margin, normalize_feature=True)
    (g,) = torch.autograd.grad(got, tf)
    assert np.isfinite(n(g)).all()
    np.testing.assert_allclose(n(got), float(want), **TOL)
    jg = np.asarray(jg)
    assert np.isnan(jg[5]).all() and np.isfinite(np.delete(jg, 5, 0)).all()
    np.testing.assert_allclose(np.delete(n(g), 5, 0), np.delete(jg, 5, 0), **TOL)
    # without normalization the loss differs: the option does something
    assert abs(n(tl.batch_hard_triplet_loss(t(feat), t(labels), margin)) - n(got)) > 1e-3


# ---------------------------------------------------------------------------
# LR rules and schedules
# ---------------------------------------------------------------------------


def _solver_cfgs(max_epochs, warmup, cosine=True):
    cfgs = []
    for cfg in (get_cfg_defaults(), tcfg.get_cfg_defaults()):
        cfg.SOLVER.MAX_EPOCHS = max_epochs
        cfg.SOLVER.WARMUP_ITERS = warmup
        cfg.TPU.ENABLE_COSINE_SCHEDULE = cosine
        cfg.SOLVER.LR_SCHEDULER = "cosine"
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("max_epochs,warmup", [(8, 2), (60, 10), (120, 5), (3, 0)])
def test_lr_tables_equal_jax_bit_for_bit(max_epochs, warmup):
    """make_lr_schedule's f32 table under the cosine recipe (its seeded
    noise drawn by torch in both packages), and the raw warmup-linear and
    cosine rules, equal JAX's exactly for every step and epoch."""
    jcfg, cfg = _solver_cfgs(max_epochs, warmup)
    spe = 3
    js, ts = jopt.make_lr_schedule(jcfg, spe), topt.make_lr_schedule(cfg, spe)
    table = [ts(s) for s in range((max_epochs + 3) * spe)]
    assert table == [js(s) for s in range((max_epochs + 3) * spe)]
    plain = topt.make_lr_schedule(_solver_cfgs(max_epochs, warmup, cosine=False)[1], spe)
    assert table != [plain(s) for s in range(len(table))]  # the knob changes the schedule
    base = cfg.SOLVER.BASE_LR
    for method in ("linear", "constant"):
        kw = dict(warmup_iters=warmup, warmup_method=method, min_lr=1e-6)
        jr, tr = (m.warmup_linear_lr(base, max_epochs, **kw) for m in (jopt, topt))
        assert [tr(e) for e in range(max_epochs + 3)] == [jr(e) for e in range(max_epochs + 3)]
    kw = dict(lr_min=1e-6, decay_rate=0.5, warmup_t=warmup, warmup_lr_init=1e-5,
              cycle_limit=0, noise_range_t=(1, max_epochs), noise_seed=7)
    jr, tr = (m.timm_cosine_lr(base, max(1, max_epochs // 2), **kw) for m in (jopt, topt))
    assert [tr(e) for e in range(2 * max_epochs)] == [jr(e) for e in range(2 * max_epochs)]


# ---------------------------------------------------------------------------
# REMAT_BACKBONE: remat against no remat
# ---------------------------------------------------------------------------


def _port_cfg(vit=False, **tpu):
    cfg = tcfg.get_cfg_defaults()
    tpresets.apply_flagship(cfg, on_tpu=False)
    tpresets.apply_tiny(cfg)
    cfg.TPU.USE_FLASH_ATTENTION = True  # the fused blocks' Functions (plain versions here)
    if vit:
        cfg.MODEL.TRANSFORMER_TYPE = "vit_base_patch16_224"
        cfg.TPU.BACKBONE_WIDTH = cfg.TPU.BACKBONE_HEADS = -1
        cfg.MODEL.DROP_PATH = 0.1
    for k, v in tpu.items():
        setattr(cfg.TPU, k, v)
    return cfg.freeze()


def _remat_step(cfg, seed=5):
    """One training forward and backward of a fresh model of `cfg` (the same
    weights whatever `cfg` says of remat) on a seeded batch, its draws from
    a seeded generator: (loss, grads, generator state after, block forward
    calls)."""
    model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    blocks = getattr(model.backbone.base, "resblocks", None) or model.backbone.base.blocks
    calls = []
    for blk in blocks:  # a pre-hook: the recompute stops once it has what it needs
        blk.register_forward_pre_hook(lambda *_: calls.append(1))
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(seed)
    images = t(rng.standard_normal((8, 3, h, w, 3)).astype(np.float32))
    pids = t(np.repeat(np.arange(4), 2)).long()
    cams = t(rng.integers(0, CAMERA_NUM, 8)).long()
    gen = torch.Generator().manual_seed(seed)
    loss, _, grads = loss_and_grads(cfg, model, tl.make_loss_fn(cfg, NUM_CLASSES), images, pids,
                                    cams, gen)
    return loss, grads, gen.get_state(), len(calls), len(blocks)


@pytest.mark.parametrize("vit", [False, True], ids=["clip", "vit_drop_path"])
def test_remat_gives_the_gradients_of_no_remat(vit):
    """REMAT_BACKBONE runs every block twice in a step (the forward, then the
    recompute in the backward) and gives the loss, every gradient and the
    generator's state after the step of the run without it, bit for bit.
    The ImageNet ViT draws drop path (0.1) from the caller's generator."""
    loss, grads, gen_state, calls, blocks = _remat_step(_port_cfg(vit))
    r_loss, r_grads, r_gen_state, r_calls, _ = _remat_step(_port_cfg(vit, REMAT_BACKBONE=True))
    assert (calls, r_calls) == (blocks, 2 * blocks)
    assert torch.equal(loss, r_loss)
    assert set(grads) == set(r_grads)
    for k in grads:
        assert torch.equal(grads[k], r_grads[k]), k
    assert torch.equal(gen_state, r_gen_state)


def test_remat_whose_recompute_draws_fresh_masks_gives_other_gradients(monkeypatch):
    """The control of the test above: the same ViT step with a checkpoint
    that lets the recompute draw from the generator as it stands (fresh
    drop-path masks) must fail that test's check."""
    loss, grads, *_ = _remat_step(_port_cfg(True))

    def fresh_masks(block, x, generator):
        return checkpoint(block, x, True, generator, use_reentrant=False)

    monkeypatch.setattr(tvit, "checkpointed_block", fresh_masks)
    f_loss, f_grads, *_ = _remat_step(_port_cfg(True, REMAT_BACKBONE=True))
    assert torch.equal(loss, f_loss)  # the forward draws what the plain forward draws
    differ = [k for k in grads if not np.allclose(n(grads[k]), n(f_grads[k]), **TOL)]
    assert any(k.startswith("backbone.base.blocks.") for k in differ), differ


def test_remat_never_recomputes_at_eval():
    cfg = _port_cfg(REMAT_BACKBONE=True)
    model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    calls = []
    for blk in model.backbone.base.resblocks:
        blk.register_forward_hook(lambda *_: calls.append(1))
    h, w = cfg.INPUT.SIZE_TEST
    model(torch.zeros(2, 3, h, w, 3, requires_grad=True), torch.zeros(2, dtype=torch.long)
          )["embedding"].sum().backward()
    assert len(calls) == len(model.backbone.base.resblocks)


# ---------------------------------------------------------------------------
# Center loss in the train state
# ---------------------------------------------------------------------------


def _center_cfg():
    cfg = tcfg.get_cfg_defaults()
    tpresets.apply_flagship(cfg, on_tpu=False)
    tpresets.apply_tiny(cfg)
    cfg.MODEL.METRIC_LOSS_TYPE = "triplet_center"
    return cfg.freeze()


def test_checkpoint_round_trip_keeps_the_centers(tmp_path):
    cfg = _center_cfg()
    model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    state = create_train_state(cfg, model, 4)
    assert state.centers.shape == (NUM_CLASSES, 2048) and state.centers.dtype == torch.float32
    state.centers.mul_(0.5).add_(1.0)
    save_checkpoint(str(tmp_path), state)
    fresh = create_train_state(cfg, make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                               generator=generator(1)), 4,
                               generator=generator(9))
    assert not torch.equal(fresh.centers, state.centers)
    restore_checkpoint(str(tmp_path), fresh)
    assert torch.equal(fresh.centers, state.centers)
    no_center = tcfg.get_cfg_defaults()
    tpresets.apply_flagship(no_center, on_tpu=False)
    tpresets.apply_tiny(no_center)
    plain = create_train_state(no_center.freeze(), make_model(
        no_center, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator()), 4)
    assert plain.centers is None and "centers" not in plain.state_dict()
    with pytest.raises(ValueError, match="center loss"):
        restore_checkpoint(str(tmp_path), plain)


# ---------------------------------------------------------------------------
# Two whole train steps with center loss, the cosine schedule and remat
# ---------------------------------------------------------------------------


def _knobs_jax_cfg():
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.TPU.USE_FLASH_ATTENTION = True
    cfg.MODEL.METRIC_LOSS_TYPE = "triplet_center"
    cfg.TPU.ENABLE_COSINE_SCHEDULE = True
    cfg.SOLVER.LR_SCHEDULER = "cosine"
    cfg.TPU.REMAT_BACKBONE = True
    cfg.SOLVER.MAX_EPOCHS = 4
    cfg.SOLVER.WARMUP_ITERS = 1
    cfg.freeze()
    return cfg


def _batches(cfg, steps=2, b=16):
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(8)
    return [(rng.standard_normal((b, 3, h, w, 3)).astype(np.float32),
             np.repeat(np.arange(b // 2), 2).astype(np.int32),
             rng.integers(0, CAMERA_NUM, b).astype(np.int32)) for _ in range(steps)]


@functools.cache
def _jax_two_steps():
    """JAX's state after each of two train steps of the tiny flagship with
    the three knobs, from random variables and its own centers."""
    cfg = _knobs_jax_cfg()
    batches = _batches(cfg)
    images, _, cams = batches[0]
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, images[:2], cams[:2], train=False, seed=8)
    sample = types.SimpleNamespace(images=images[:2], camids=cams[:2], viewids=cams[:2] * 0)
    jstate, tx, ctx, _ = jax_state_from(cfg, jmodel, variables, sample)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
    step = j_build_train_step(cfg, jmodel, tx, ctx, donate=False)
    states, metrics = [jstate], []
    for images, pids, cams in batches:
        jstate, m = step(jstate, jnp.asarray(images), jnp.asarray(pids), jnp.asarray(cams),
                         jnp.asarray(cams * 0), jax.random.PRNGKey(1))
        states.append(jstate)
        metrics.append(float(m["loss"]))
    return cfg, batches, variables, states, metrics


def test_two_train_steps_with_center_loss_cosine_and_remat_match_jax(no_flax_dropout):
    """From the JAX state carried across (its centers included): each step's
    loss, the centers after each step (the 1 / CENTER_LOSS_WEIGHT rescale and
    the SGD), and the parameters and BatchNorm statistics after each step,
    held as test_torch_train.py's one-step test holds them."""
    cfg, batches, variables, states, metrics = _jax_two_steps()
    assert cfg.TPU.REMAT_BACKBONE and states[0].centers is not None
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), variables)
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    state = create_train_state(cfg, port, 4)
    convert_train_state(variables, states[0].opt_state, state, centers=states[0].centers)
    np.testing.assert_array_equal(n(state.centers), np.asarray(states[0].centers))
    step = build_host_train_step(cfg, port, state, CPU)
    lrs = []
    for i, (images, pids, cams) in enumerate(batches):
        lrs.append(state.schedule(state.step))
        before = state.centers.clone()
        out = step(t(images), t(pids).long(), t(cams).long(), t(cams * 0).long())
        np.testing.assert_allclose(n(out["loss"]), metrics[i], rtol=1e-5)
        assert not torch.equal(state.centers, before)
        jstate = states[i + 1]
        np.testing.assert_allclose(n(state.centers), np.asarray(jstate.centers), **TOL)
        want = convert_flax_variables({"params": jstate.params,
                                       "batch_stats": jstate.batch_stats}, port)
        # Adam moves each weight by about lr * sign(grad) a step: a gradient
        # within summation noise of 0 may move it by up to that, so elements
        # are held to 1e-6 and at most 0.1% may stray up to the bound.  The
        # keys' bias (the middle third of an in_proj_bias) has an analytic
        # gradient of 0, as a softmax does not see a shift of its row: it is
        # all summation noise, so those elements are held to the bound only.
        for k, v in port.state_dict().items():
            d = np.abs(n(v) - n(want[k]))
            assert d.max() <= 2 * sum(lrs) + 1e-6, k
            if k.endswith("in_proj_bias"):  # the key bias: a gradient of 0 up to noise
                c = d.shape[0] // 3
                d = np.concatenate([d[:c], d[2 * c:]])
            assert (d > 1e-6).mean() <= 1e-3, (k, d.max())
    assert state.step == 2


def test_loss_and_grads_returns_the_centers_gradient():
    """With the train state's centers, loss_and_grads adds the weighted center
    loss of the first branch's feature (over min(2048, width) columns) and
    returns the centers' gradient beside the parameters'."""
    cfg = _center_cfg()
    model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    for mlp in model.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0  # the three forwards below see the same features
    state = create_train_state(cfg, model, 4)
    h, w = cfg.INPUT.SIZE_TRAIN
    images = t(np.random.default_rng(1).standard_normal((4, 3, h, w, 3)).astype(np.float32))
    pids = torch.tensor([0, 0, 1, 1])
    init = {k: v.clone() for k, v in model.state_dict().items()}
    base, _, g0 = loss_and_grads(cfg, model, tl.make_loss_fn(cfg, NUM_CLASSES), images, pids,
                                 pids, None)
    model.load_state_dict(init)
    loss, _, g = loss_and_grads(cfg, model, tl.make_loss_fn(cfg, NUM_CLASSES), images, pids,
                                pids, None, centers=state.centers)
    assert CENTERS not in g0 and set(g) == set(g0) | {CENTERS}
    gc = g[CENTERS]
    feat = next(iter(model(images, pids, train=True)["branches"].values()))[1]
    width = feat.shape[-1]
    assert width < 2048 and not gc[:, width:].any() and gc[:2, :width].abs().sum() > 0
    assert not gc[2:].any()  # classes outside the batch
    want = base + cfg.SOLVER.CENTER_LOSS_WEIGHT * tl.center_loss(
        state.centers[:, :width], feat.detach(), pids)
    np.testing.assert_allclose(n(loss), n(want), **TOL)
