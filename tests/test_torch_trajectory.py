"""Many train steps of the tiny flagship against the JAX package on the CPU
(fault F6 of ROADMAP.md: the port's quality gate ends above JAX's band,
while every parity test took one or two steps).  From JAX's own initial
state (its initialisers, converted with its Adam state), both packages take
TRAJECTORY_STEPS f32 steps on the same PK batches of SyntheticTriModal's
hard recipe (RandomIdentitySampler's order; no augmentation, dropout off on
both sides), and the loss of every step, the parameters and the BatchNorm
statistics after the last are held to the bounds below.  The per-step
losses and the drifts are printed (pytest -s)."""

import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.engine import create_train_state as j_create_train_state
from demo2_tpu.engine.train import build_train_step as j_build_train_step
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu_torch.data.datasets import SyntheticTriModal
from demo2_tpu_torch.data.sampler import RandomIdentitySampler
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.engine.train import build_host_train_step
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.utils.converters import convert_flax_variables, convert_train_state
from torch_port_helpers import CPU, generator, load_port, n, t

TRAJECTORY_STEPS = 20
NUM_PIDS, CAMERA_NUM = 16, 4
# The bounds.  The loss of every step is held to LOSS_REL of JAX's.  Adam
# moves a weight by at most about lr a step whatever the gradient, so two
# trajectories whose gradients differ by summation noise may part by up to
# 2 x the summed lr where a gradient sits within noise of 0: every element
# is held to that, which alone could not fail.  So each parameter is held
# as a whole as well: its distance from JAX's after the steps is at most
# PARAM_REL of the distance JAX's moved it (norms over the tensor), which an
# update that differs by more than rounding breaks.  Exempt from that are
# the elements whose gradient is 0 up to noise (_zero_gradient_split): they
# move by noise alone, so they are held to the lr bound only, their drifts
# printed.  The BatchNorm statistics, means over the batches of features
# that all the parameters make, are held to STATS_REL of their norm.
LOSS_REL = 1e-4
PARAM_REL = 1e-2
STATS_REL = 1e-4


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side; the port gets a dropout rate of 0."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _cfg(fused):
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.TPU.USE_FLASH_ATTENTION = fused
    cfg.MODEL.SDTPS_CROSS_ATTN_TYPE = "attention"
    cfg.SOLVER.MAX_EPOCHS = 8
    return cfg.freeze()


def _batches(cfg):
    """TRAJECTORY_STEPS PK batches (IMS_PER_BATCH of NUM_INSTANCE per id) of
    the hard synthetic tri-modal images, normalised as the eval transform
    does: (images (B, 3, H, W, 3) f32, pids, cams) numpy arrays."""
    ds = SyntheticTriModal(num_pids=NUM_PIDS, num_cams=CAMERA_NUM, imgs_per_pid=4,
                           image_size=tuple(cfg.INPUT.SIZE_TRAIN), seed=0, hard=True)
    pixels = ds.render_all(ds.train)
    bs = cfg.SOLVER.IMS_PER_BATCH
    sampler = RandomIdentitySampler(ds.train, bs, cfg.DATALOADER.NUM_INSTANCE, seed=0)
    order = np.concatenate([sampler.epoch_indices(e) for e in range(1, 1 + TRAJECTORY_STEPS)])
    pids = np.asarray([s[1] for s in ds.train], np.int32)
    cams = np.asarray([s[2] for s in ds.train], np.int32)
    out = []
    for i in range(TRAJECTORY_STEPS):
        idx = order[i * bs:(i + 1) * bs]
        images = (pixels[idx].astype(np.float32) / 255.0 - 0.5) / 0.5
        out.append((images, pids[idx], cams[idx]))
    return out, max(1, len(sampler) // bs)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_twenty_steps_follow_jax(fused, no_flax_dropout):
    cfg = _cfg(fused)
    batches, steps_per_epoch = _batches(cfg)
    images, _, cams = batches[0]
    jmodel = j_make_model(cfg, NUM_PIDS, CAMERA_NUM)
    sample = types.SimpleNamespace(images=images[:2], camids=cams[:2], viewids=cams[:2] * 0)
    jstate, tx, ctx, _ = j_create_train_state(cfg, jmodel, jax.random.PRNGKey(0), sample,
                                              steps_per_epoch)
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    port = load_port(make_model(cfg, NUM_PIDS, CAMERA_NUM, device=CPU, generator=generator()),
                     variables)
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    state = create_train_state(cfg, port, steps_per_epoch)
    convert_train_state(variables, jstate.opt_state, state)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    jstep = j_build_train_step(cfg, jmodel, tx, ctx, donate=False)
    step = build_host_train_step(cfg, port, state, CPU)
    rows, lrs = [], []
    for images, pids, cams in batches:
        lrs.append(state.schedule(state.step))
        jstate, m = jstep(jstate, jnp.asarray(images), jnp.asarray(pids), jnp.asarray(cams),
                          jnp.asarray(cams * 0), jax.random.PRNGKey(1))
        out = step(t(images), t(pids).long(), t(cams).long(), t(cams * 0).long())
        rows.append((float(m["loss"]), n(out["loss"]).item()))
    want = convert_flax_variables({"params": jstate.params,
                                   "batch_stats": jstate.batch_stats}, port)
    diffs = {k: np.abs(n(v) - n(want[k])).ravel() for k, v in port.state_dict().items()}
    drift = {k: float(d.max()) for k, d in diffs.items()}
    worst = max(drift, key=drift.get)
    params = {k for k, _ in port.named_parameters()}
    param_rel, exempt, stats_rel = {}, {}, {}
    for k, d in diffs.items():
        if k not in params:  # BatchNorm statistics
            stats_rel[k] = float(np.linalg.norm(d) / np.linalg.norm(n(want[k])))
            continue
        zero, rest = _zero_gradient_split(k, d)
        _, moved = _zero_gradient_split(k, np.abs(n(want[k]) - n(start[k])).ravel())
        if rest.size:  # a tensor JAX did not move must not move either
            param_rel[k] = float(np.linalg.norm(rest) / max(np.linalg.norm(moved), 1e-30))
        if zero.size:
            exempt[k] = float(zero.max())
    most = max(param_rel, key=param_rel.get)
    stat = max(stats_rel, key=stats_rel.get)
    rel = [abs(p - j) / abs(j) for j, p in rows]
    print(f"\n[trajectory {'fused' if fused else 'plain'}] step: JAX loss / port loss")
    for i, (j, p) in enumerate(rows):
        print(f"  {i + 1:2d}: {j:.6f} / {p:.6f}  (rel {rel[i]:.2e}, lr {lrs[i]:.3e})")
    print(f"  largest drift after {len(rows)} steps: {drift[worst]:.3e} ({worst}); "
          f"bound 2 x summed lr = {2 * sum(lrs):.3e}")
    print(f"  largest drift of a parameter against its movement: {param_rel[most]:.3e} "
          f"({most}); bound {PARAM_REL:g}")
    for k, d in exempt.items():
        print(f"  zero-gradient elements of {k}: largest drift {d:.3e}")
    print(f"  largest relative drift of a BatchNorm statistic: {stats_rel[stat]:.3e} ({stat}); "
          f"bound {STATS_REL:g}")
    assert max(rel) <= LOSS_REL, rel
    assert rows[-1][0] < rows[0][0]  # both learn
    for k, d in drift.items():
        assert d <= 2 * sum(lrs) + 1e-6, (k, d)
    assert {k: v for k, v in param_rel.items() if v > PARAM_REL} == {}
    assert {k: v for k, v in stats_rel.items() if v > STATS_REL} == {}


def _zero_gradient_split(name: str, d: np.ndarray):
    """(the elements of the drift `d` of parameter `name` whose gradient is 0
    up to noise, the others).  The key biases: the key third of each qkv
    bias and SDTPS's k_proj_bias (a softmax over the keys is unchanged by a
    shift of every key's logit alike); and DGAF's modal-enhance LayerNorm
    bias (a shift of every sample's fused feature alike, which the head's
    train-mode BatchNorm and the triplet distances both cancel)."""
    if name.endswith("in_proj_bias"):
        c = d.shape[0] // 3
        return d[c:2 * c], np.concatenate([d[:c], d[2 * c:]])
    if name in ("sdtps.k_proj_bias", "dgaf.modal_enhance.ln.bias"):
        return d, d[:0]
    return d[:0], d
