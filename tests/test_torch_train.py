"""The port's training slice against the JAX package on the CPU.

Losses, branch weights, the optimizer chain, train-mode BatchNorm, the
on-device augmentation, the PK sampler and the synthetic dataset are each held
against their JAX counterparts on inputs made by numpy from a seed; then one
whole train step of the tiny flagship DeMo in f32 (loss, every gradient, the
parameters after Adam and the BatchNorm statistics) against JAX's
build_train_step, and do_train end to end with eval and resume.
"""

import functools
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.data import device_cache as jdc
from demo2_tpu.data.datasets import SyntheticTriModal as JSynthetic
from demo2_tpu.data.sampler import RandomIdentitySampler as JSampler
from demo2_tpu.engine.train import build_train_step as j_build_train_step
from demo2_tpu.losses import losses as jl
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.ops.norm import TorchBatchNorm as JBatchNorm
from demo2_tpu.solver.optim import make_optimizer as j_make_optimizer
from demo2_tpu_torch.data import device_cache as dc
from demo2_tpu_torch.data.datasets import SyntheticTriModal
from demo2_tpu_torch.data.sampler import RandomIdentitySampler
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.engine.train import do_train, loss_and_grads
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.ops.packed_attention import attention_bwd_saved as pa_bwd_saved
from demo2_tpu_torch.ops.norm import TorchBatchNorm
from demo2_tpu_torch.solver.optim import Optimizer
from demo2_tpu_torch.utils.checkpoint import restore_checkpoint
from demo2_tpu_torch.utils.converters import convert_flax_variables, convert_train_state
from torch_port_helpers import CPU, generator, jax_state_from, load_port, n, random_variables, t

# f32 on both sides: only the summation order differs.
TOL = dict(rtol=1e-5, atol=1e-6)


def _cfg(**solver):
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.TPU.USE_FLASH_ATTENTION = True
    for k, v in solver.items():
        setattr(cfg.SOLVER, k, v)
    return cfg


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _feats(seed, b=16, d=24, classes=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, classes)).astype(np.float32) * 3,
            rng.standard_normal((b, d)).astype(np.float32),
            np.repeat(np.arange(b // 2), 2).astype(np.int32))


@pytest.mark.parametrize("name", ["softmax_cross_entropy", "cross_entropy_label_smooth"])
def test_id_losses_match_jax(name):
    logits, _, labels = _feats(1)
    want = getattr(jl, name)(jnp.asarray(logits), jnp.asarray(labels))
    got = getattr(tl, name)(t(logits), t(labels))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("margin", [None, 0.3], ids=["soft_margin", "margin"])
def test_batch_hard_triplet_matches_jax(margin):
    _, feat, labels = _feats(2)
    got_d = n(tl.euclidean_dist(t(feat), t(feat)))
    want_d = np.asarray(jl.euclidean_dist(jnp.asarray(feat), jnp.asarray(feat)))
    # The diagonal is the sqrt of f32 cancellation noise (or the 1e-12 clamp).
    off = ~np.eye(len(feat), dtype=bool)
    np.testing.assert_allclose(got_d[off], want_d[off], **TOL)
    assert got_d.diagonal().max() < 1e-2 and want_d.diagonal().max() < 1e-2
    want = jl.batch_hard_triplet_loss(jnp.asarray(feat), jnp.asarray(labels), margin=margin)
    got = tl.batch_hard_triplet_loss(t(feat), t(labels), margin=margin)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("sampler,smooth,no_margin", [
    ("softmax_triplet", "on", True), ("softmax_triplet", "off", False), ("softmax", "on", True)])
def test_make_loss_fn_matches_jax(sampler, smooth, no_margin):
    cfg = _cfg()
    cfg.DATALOADER.SAMPLER = sampler
    cfg.MODEL.IF_LABELSMOOTH = smooth
    cfg.MODEL.NO_MARGIN = no_margin
    logits, feat, labels = _feats(3)
    want = jl.make_loss_fn(cfg, 8)(jnp.asarray(logits), jnp.asarray(feat), jnp.asarray(labels))
    got = tl.make_loss_fn(cfg, 8)(t(logits), t(feat), t(labels))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_sdtps", [True, False])
def test_branch_weights_match_jax(use_sdtps):
    cfg = _cfg()
    cfg.MODEL.USE_SDTPS = use_sdtps
    for names in (["dgaf"], ["dgaf", "ori_r", "ori_n", "ori_t"]):
        assert tl.branch_weights(cfg, names) == jl.branch_weights(cfg, names)
    if use_sdtps:  # the flagship's only branch carries SDTPS_LOSS_WEIGHT = 2.0
        assert tl.branch_weights(cfg, ["dgaf"]) == {"dgaf": 2.0}


def test_quantile_gradient_matches_jax():
    """SDTPS's soft-mask threshold (sdtps.py:165): torch.quantile's gradient
    against jnp.quantile's, both linear interpolation between order stats."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 5, 37)).astype(np.float32)
    w = rng.standard_normal((3, 5, 1)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.quantile(a, 0.3, axis=-1, keepdims=True) * w))(
        jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    (torch.quantile(xt, 0.3, dim=-1, keepdim=True) * t(w)).sum().backward()
    np.testing.assert_allclose(n(xt.grad), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

_PARAM_SHAPES = {"blk.weight": (6, 5), "blk.in_proj_bias": (6,), "ln.weight": (5,),
                 "head.classifier.weight": (4, 6)}


@pytest.mark.parametrize("name,mu,nu", [
    ("Adam", False, False), ("Adam", True, False), ("Adam", True, True),
    ("AdamW", False, False), ("SGD", False, False)])
def test_optimizer_three_steps_match_optax_chain(name, mu, nu):
    cfg = _cfg(OPTIMIZER_NAME=name, WEIGHT_DECAY=0.01, WEIGHT_DECAY_BIAS=0.1, LARGE_FC_LR=True,
               BASE_LR=1e-2, MAX_EPOCHS=4)
    cfg.TPU.BF16_MOMENTS, cfg.TPU.BF16_SECOND_MOMENT = mu, nu
    rng = np.random.default_rng(4)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in _PARAM_SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in _PARAM_SHAPES.items()}
             for _ in range(3)]
    # steps_per_epoch = 1: the LR changes at every step (warmup epochs 1-3).
    tx, _, _ = j_make_optimizer(cfg, params, 1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    port = {k: torch.nn.Parameter(t(v.copy())) for k, v in params.items()}
    opt = Optimizer(cfg, port, 1)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step({k: t(v) for k, v in g.items()})
    # bf16 moments: one f32 rounding step apart, a moment can round to the
    # neighbouring bf16 value (2^-8 relative), which moves that element's
    # update by as much; 2^-8 of the largest update bounds it.
    atol = 1e-2 * 2 ** -8 * 3 if mu else TOL["atol"]
    for k in params:
        np.testing.assert_allclose(n(port[k]), np.asarray(jp[k]), rtol=TOL["rtol"], atol=atol,
                                   err_msg=k)
    assert opt.count == 3


# ---------------------------------------------------------------------------
# BatchNorm in train mode
# ---------------------------------------------------------------------------


def test_batchnorm_train_mode_and_running_update_match_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((16, 12)) * 2 + 3).astype(np.float32)
    variables = {"params": {"scale": 1 + 0.1 * rng.standard_normal(12).astype(np.float32),
                            "bias": 0.1 * rng.standard_normal(12).astype(np.float32)},
                 "batch_stats": {"mean": rng.standard_normal(12).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, 12).astype(np.float32)}}
    want, mutated = JBatchNorm().apply(variables, jnp.asarray(x), False, mutable=["batch_stats"])
    bn = TorchBatchNorm(12, device=CPU, use_bias=True)
    bn.load_state_dict(convert_flax_variables(variables, bn))
    got = bn(t(x), train=True)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(n(bn.running_mean), np.asarray(mutated["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(n(bn.running_var), np.asarray(mutated["batch_stats"]["var"]), **TOL)
    eval_want = JBatchNorm().apply({"params": variables["params"],
                                    "batch_stats": mutated["batch_stats"]}, jnp.asarray(x), True)
    np.testing.assert_allclose(n(bn(t(x))), np.asarray(eval_want), **TOL)


# ---------------------------------------------------------------------------
# Data: augmentation, sampler, synthetic images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gathered", [False, True], ids=["batch", "cache_idx"])
def test_apply_augment_matches_jax_given_its_params_and_noise(gathered):
    rng = np.random.default_rng(6)
    size, b = (24, 12), 5
    u8 = rng.integers(0, 256, size=(9 if gathered else b, 3, *size, 3), dtype=np.uint8)
    idx = np.asarray([7, 0, 3, 3, 8], np.int32) if gathered else None
    params = jdc.draw_aug_params(jax.random.PRNGKey(3), b, size, re_prob=0.9)
    noise = jax.random.normal(params["noise_key"], (b, 3, *size, 3), jnp.float32)
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.5)
    want = jdc.apply_augment(jnp.asarray(u8), params, mean, std, padding=3,
                             idx=None if idx is None else jnp.asarray(idx))
    tparams = {k: t(np.asarray(v)) for k, v in params.items() if k != "noise_key"}
    got = dc.apply_augment(t(u8), tparams, mean, std, t(np.asarray(noise)), padding=3,
                           idx=None if idx is None else t(idx))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-6)
    assert bool(np.asarray(params["erase"]).any()) and bool(np.asarray(params["flip"]).any())


def test_draw_aug_params_stay_in_range():
    g = torch.Generator().manual_seed(0)
    size = (32, 16)
    p = dc.draw_aug_params(g, 256, size, device=CPU, padding=4)
    assert p["crop_top"].min() >= 0 and p["crop_top"].max() <= 8
    assert 0.3 < p["flip"].float().mean() < 0.7
    e = p["erase"]
    assert 0.3 < e.float().mean() < 0.6
    assert bool((p["erase_top"][e] + p["erase_h"][e] <= size[0]).all())
    assert bool((p["erase_left"][e] + p["erase_w"][e] <= size[1]).all())
    assert bool((p["erase_h"][e] < size[0]).all() and (p["erase_w"][e] < size[1]).all())


def test_sampler_and_synthetic_render_match_jax():
    jds = JSynthetic(num_pids=6, imgs_per_pid=5, image_size=(16, 8), seed=2)
    ds = SyntheticTriModal(num_pids=6, imgs_per_pid=5, image_size=(16, 8), seed=2)
    assert ds.train == jds.train and ds.query == jds.query and ds.gallery == jds.gallery
    want = np.stack([np.stack(jds.render(s[0])) for s in jds.gallery])
    np.testing.assert_array_equal(ds.render_all(ds.gallery), want)
    hard = dict(num_pids=4, imgs_per_pid=2, image_size=(8, 8), hard=True, id_weight=0.2)
    np.testing.assert_array_equal(SyntheticTriModal(**hard).render_all(ds.train[:3]),
                                  np.stack([np.stack(JSynthetic(**hard).render(s[0]))
                                            for s in ds.train[:3]]))
    js, ts = JSampler(jds.train, 8, 2, seed=9), RandomIdentitySampler(ds.train, 8, 2, seed=9)
    assert len(js) == len(ts)
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(ts.epoch_indices(epoch), js.epoch_indices(epoch))


# ---------------------------------------------------------------------------
# One whole train step against JAX's build_train_step
# ---------------------------------------------------------------------------

NUM_CLASSES, CAMERA_NUM = 8, 4


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


@functools.cache
def _jax_case():
    """The tiny flagship's inputs and random variables, and JAX's train step
    from them: (cfg, images, pids, cams, jmodel, variables, loss, grads,
    state after the step, metrics).  Callers turn flax's dropout off."""
    cfg = _cfg(BASE_LR=3.5e-4)
    cfg.freeze()
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(8)
    images = rng.standard_normal((16, 3, h, w, 3)).astype(np.float32)
    pids = np.repeat(np.arange(8), 2).astype(np.int32)
    cams = rng.integers(0, CAMERA_NUM, 16).astype(np.int32)
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, images[:2], cams[:2], train=False, seed=8)
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
    return (cfg, images, pids, cams, jmodel, variables, float(j_loss_value), j_grads,
            new_jstate, metrics)


def _port_model(cfg, variables):
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), variables)
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    return port


def test_one_train_step_matches_jax(no_flax_dropout):
    cfg, images, pids, cams, _, variables, j_loss, j_grads, new_jstate, metrics = _jax_case()
    np.testing.assert_allclose(float(metrics["loss"]), j_loss, rtol=1e-6)
    port = _port_model(cfg, variables)

    # The port: the step's forward and backward (BN statistics updated), then Adam.
    loss, acc, grads = loss_and_grads(cfg, port, tl.make_loss_fn(cfg, NUM_CLASSES), t(images),
                                      t(pids).long(), t(cams).long(), None)
    np.testing.assert_allclose(n(loss), j_loss, rtol=1e-5)
    np.testing.assert_allclose(n(acc), float(metrics["acc"]))
    want_grads = convert_flax_variables({"params": j_grads, "batch_stats": variables["batch_stats"]},
                                        port)
    assert set(grads) == {k for k, _ in port.named_parameters()}
    # Per tensor: 1e-4 of its largest element, and 1e-6 of the model's largest
    # (some grads are zero up to f32 noise, e.g. a bias the BNNeck cancels).
    top = max(np.abs(n(want_grads[k])).max() for k in grads)
    for k, g in grads.items():
        w = n(want_grads[k])
        np.testing.assert_allclose(n(g), w, rtol=1e-3, atol=1e-4 * np.abs(w).max() + 1e-6 * top,
                                   err_msg=k)
    state = create_train_state(cfg, port, 4)
    state.optimizer.step(grads)
    want = convert_flax_variables({"params": new_jstate.params,
                                   "batch_stats": new_jstate.batch_stats}, port)
    # Adam's first step moves each weight by about lr * sign(grad): a grad
    # within summation noise of 0 may move by any amount up to lr (3.8e-5
    # at warmup epoch 1), so elements are held to 1e-6 and at most 0.1% of
    # them may stray up to that bound.
    lr = state.schedule(0)
    for k, v in port.state_dict().items():
        d = np.abs(n(v) - n(want[k]))
        assert d.max() <= 2 * lr + 1e-6, k
        assert (d > 1e-6).mean() <= 1e-3, (k, d.max())


# ---------------------------------------------------------------------------
# do_train end to end, eval and resume
# ---------------------------------------------------------------------------


def _train_setup(cfg):
    ds = SyntheticTriModal(num_pids=8, imgs_per_pid=4, image_size=tuple(cfg.INPUT.SIZE_TRAIN))
    train = dc.DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True, cfg=cfg,
                                       device=CPU)
    val_samples = ds.query + ds.gallery
    val = dc.DeviceCache.from_arrays(ds.render_all(val_samples), val_samples, train=False,
                                     cfg=cfg, device=CPU)
    sampler = RandomIdentitySampler(ds.train, cfg.SOLVER.IMS_PER_BATCH,
                                    cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED)
    model = make_model(cfg, ds.num_train_pids, ds.num_train_cams, device=CPU,
                       generator=generator(0))
    return ds, train, val, sampler, model


def test_do_train_learns_evaluates_and_resumes(tmp_path):
    cfg = _cfg(MAX_EPOCHS=3, EVAL_PERIOD=1, CHECKPOINT_PERIOD=1, LOG_PERIOD=1,
               BASE_LR=3.5e-3, WARMUP_ITERS=0)
    cfg.TEST.IMS_PER_BATCH = 24
    cfg.freeze()
    ds, train, val, sampler, model = _train_setup(cfg)
    steps = len(sampler) // cfg.SOLVER.IMS_PER_BATCH
    state = create_train_state(cfg, model, steps)
    ckpt = str(tmp_path / "ckpt")
    state, best = do_train(cfg, state, train, sampler, val, len(ds.query), checkpoint_dir=ckpt)
    losses = [e["loss"] for e in state.history]
    assert [e["epoch"] for e in state.history] == [1, 2, 3]
    assert losses[-1] < losses[0], losses
    assert all(0.0 < e["mAP"] <= 1.0 for e in state.history)
    assert best["mAP"] == max(e["mAP"] for e in state.history)
    assert state.step == 3 * steps
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        f"step_{steps}.pt", f"step_{2 * steps}.pt", f"step_{3 * steps}.pt"]
    assert any((tmp_path / "ckpt_best").iterdir())

    # Resume from the end of epoch 2: epoch 3 replays the same draws.
    _, _, _, _, fresh = _train_setup(cfg)
    resumed = restore_checkpoint(ckpt, create_train_state(cfg, fresh, steps), step=2 * steps)
    assert resumed.step == 2 * steps
    resumed, _ = do_train(cfg, resumed, train, sampler)
    assert [e["epoch"] for e in resumed.history] == [3]
    # The same trajectory up to CPU summation noise: Adam turns the noise of
    # a gradient that is zero in exact arithmetic (the key bias under the
    # softmax) into steps of up to lr, so a few elements may stray.
    a, b = resumed.model.state_dict(), state.model.state_dict()
    diffs = torch.cat([(a[k].float() - b[k].float()).abs().flatten() for k in b])
    assert (diffs > 1e-6).float().mean().item() < 1e-3
    assert diffs.max().item() <= 2 * cfg.SOLVER.BASE_LR


def test_converter_carries_jax_train_state(no_flax_dropout):
    """JAX's params, batch_stats and Adam state after a step, carried into
    the port's TrainState: strict both ways."""
    cfg, _, _, _, _, variables, _, _, new_jstate, _ = _jax_case()
    port = _port_model(cfg, variables)
    state = create_train_state(cfg, port, 4)
    convert_train_state({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats},
                        new_jstate.opt_state, state)
    assert state.step == 1
    adam = [s for s in jax.tree_util.tree_leaves(
        new_jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    mu = convert_flax_variables({"params": adam.mu, "batch_stats": variables["batch_stats"]}, port)
    k = "backbone.base.resblocks.0.attn.in_proj_weight"
    np.testing.assert_array_equal(n(state.optimizer.state[k]["mu"]), n(mu[k]))
    np.testing.assert_array_equal(
        n(state.model.state_dict()["head_dgaf.bottleneck.bn.running_var"]),
        np.asarray(new_jstate.batch_stats["head_dgaf"]["bottleneck"]["bn"]["var"]))
    extra = dict(adam.mu)
    extra["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no port tensor"):
        convert_train_state({"params": new_jstate.params,
                             "batch_stats": new_jstate.batch_stats},
                            (adam._replace(mu=extra),), state)


def test_input_gradient_through_frozen_model_matches_jax(monkeypatch, no_flax_dropout):
    """d(sum of embedding norms)/d(images) at eval with the weights frozen,
    as demo2_tpu/visualize/saliency.py::gradcam_heatmaps takes it: the fused
    attention's backward runs without db (the kernel-7 route on the card)
    and the MLP unfused, since the fused MLP kernel has no backward."""
    from demo2_tpu_torch.ops import fused_block as fb

    cfg, images, _, cams, jmodel, variables = _jax_case()[:6]
    port = _port_model(cfg, variables)
    x = jnp.asarray(images[:4])
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def score(im):
        emb = jmodel.apply(jvars, im, jnp.asarray(cams[:4]), train=False)["embedding"]
        return jnp.sum(jnp.linalg.norm(emb, axis=-1))

    want = jax.jit(jax.grad(score))(x)
    calls = []
    monkeypatch.setattr(fb, "attention_bwd_saved",
                        lambda *a, **k: calls.append(1) or pa_bwd_saved(*a, **k))
    port.requires_grad_(False)
    im = t(images[:4]).requires_grad_(True)
    emb = port(im, t(cams[:4]).long(), train=False)["embedding"]
    emb.norm(dim=-1).sum().backward()
    assert len(calls) == len(port.backbone.base.resblocks)
    np.testing.assert_allclose(n(im.grad), np.asarray(want), rtol=1e-3,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


def test_bf16_step_updates_every_parameter():
    cfg = _cfg(BASE_LR=3.5e-4)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.freeze()
    ds, train, _, sampler, model = _train_setup(cfg)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model, 2)
    from demo2_tpu_torch.engine.train import build_train_step

    # Two steps: SDTPS's modal-weight MLPs end in a zero-initialised layer,
    # which passes no gradient back to their zero biases in the first.
    step = build_train_step(cfg, model, state, train)
    order = torch.from_numpy(sampler.epoch_indices(1))
    bs = cfg.SOLVER.IMS_PER_BATCH
    for i in range(2):
        assert np.isfinite(n(step(order[i * bs:(i + 1) * bs])["loss"]))
    stale = [k for k, v in model.state_dict().items() if torch.equal(v, before[k])]
    assert stale == [], stale
