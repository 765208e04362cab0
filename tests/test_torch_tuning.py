"""The CLIP tower's tuning paths against the JAX package on the CPU: LoRA on
the in-projection (whole matrix and the merged q / k / v slices), ConvLoRA
on the patch embed, the FFN adapter, the modality prompts, and MODEL.FROZEN's
rule.  Every flax leaf is a seeded random value (LoRA's B and the prompts
too: their zero init would hide the delta), loaded into the port through the
converter; inputs are seeded numpy arrays given to both.  f32: modules at
TOL, the assembled model's outputs at DeMo's TOL_MODEL
(tests/test_torch_demo.py's), two whole train steps as the training knobs'
test holds them."""

import functools
import types

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.engine.train import build_train_step as j_build_train_step
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.models.clip_vit import FFNAdapter as JFFNAdapter
from demo2_tpu.models.clip_vit import ResidualAttentionBlock as JBlock
from demo2_tpu.ops import attention as jattn
from demo2_tpu.solver.optim import make_optimizer as j_make_optimizer
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.engine.train import build_host_train_step
from demo2_tpu_torch.models import clip_vit, make_model
from demo2_tpu_torch.models.demo import is_frozen
from demo2_tpu_torch.ops import attention as tattn
from demo2_tpu_torch.utils.converters import convert_flax_variables, convert_train_state
from torch_port_helpers import (CPU, apply_jit, generator, jax_state_from, load_port, n,
                                random_variables, t)

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES, CAMERA_NUM = 8, 4

CASES = {  # the six configurations, as (section, key, value) settings of the tiny flagship
    "lora_qkv": (("MODEL", "FROZEN", True),),
    "lora_qv": (("MODEL", "FROZEN", True), ("TPU", "LORA_ENABLE", "qv")),
    "lora_conv": (("MODEL", "FROZEN", True), ("TPU", "LORA_CONV", True)),
    "frozen_adapter": (("MODEL", "FROZEN", True), ("MODEL", "ADAPTER", True),
                       ("TPU", "LORA_RANK", 0)),
    "adapter": (("MODEL", "ADAPTER", True),),
    "prompt": (("MODEL", "PROMPT", True),),
}


def _cfg(case, fused=True, vit=False, remat=False):
    """The tiny f32 flagship (one config object, read by both packages) with
    `case`'s settings; `fused` takes the fused blocks (their plain versions
    here, the Pallas kernels' references in JAX)."""
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.TPU.USE_FLASH_ATTENTION = fused
    cfg.TPU.REMAT_BACKBONE = remat
    cfg.MODEL.SDTPS_CROSS_ATTN_TYPE = "attention"
    if vit:
        cfg.MODEL.TRANSFORMER_TYPE = "vit_base_patch16_224"
        cfg.TPU.BACKBONE_WIDTH = cfg.TPU.BACKBONE_HEADS = -1
    for section, key, value in CASES[case]:
        setattr(getattr(cfg, section), key, value)
    return cfg.freeze()


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _normal(*shape, seed=0, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enable", [(True, False, True), (True, True, False),
                                    (False, True, False)], ids=["qv", "qk", "k"])
def test_merged_lora_delta_matches_jax(enable):
    n_on, c, r = sum(enable), 16, 3
    a, b = _normal(n_on, c, r, seed=1), _normal(n_on, r, c, seed=2)
    want = np.asarray(jattn.merged_lora_delta(jnp.asarray(a), jnp.asarray(b), enable, 1.0))
    got = tattn.merged_lora_delta(t(a), t(b), enable)
    assert got.shape == (c, 3 * c)
    np.testing.assert_allclose(n(got), want, **TOL)
    for i, e in enumerate(enable):  # disabled slices stay zero
        assert bool(np.any(want[:, i * c:(i + 1) * c])) == e


def test_conv_lora_delta_matches_jax():
    """The port's OIHW delta is JAX's HWIO delta transposed."""
    r, k, out_ch = 2, 4, 8
    a, b = _normal(r * k, 3 * k, seed=3), _normal(out_ch * k, r * k, seed=4)
    want = np.asarray(jattn.conv_lora_delta(jnp.asarray(a), jnp.asarray(b), out_ch, 3, k, 1.0))
    got = tattn.conv_lora_delta(t(a), t(b), out_ch, 3, k)
    np.testing.assert_allclose(n(got), want.transpose(3, 2, 0, 1), **TOL)


def test_ffn_adapter_matches_jax():
    x = _normal(3, 5, 32, seed=5)
    jm = JFFNAdapter(32)
    var = random_variables(jm, x)
    port = load_port(clip_vit.FFNAdapter(32, dtype=F32, device=CPU, generator=generator()), var)
    np.testing.assert_allclose(n(port(t(x))), np.asarray(apply_jit(jm, var, x)), **TOL)


@pytest.mark.parametrize("enable", [(True, True, True), (True, False, True), (False, True, False)],
                         ids=["qkv", "qv", "k"])
def test_mha_with_lora_matches_jax(enable):
    """Self-attention with a random LoRA adapter, and the eval call's merged
    weight served from the cache until B changes in place."""
    x = _normal(2, 7, 32, seed=6)
    jm = jattn.MultiHeadAttention(num_heads=4, lora_rank=3, lora_enable=enable)
    var = random_variables(jm, x, seed=6)
    port = load_port(tattn.MultiHeadAttention(32, 4, dtype=F32, device=CPU, generator=generator(),
                                              lora_rank=3, lora_enable=enable), var)
    assert port.lora_a.shape == var["params"]["lora_a"].shape
    np.testing.assert_allclose(n(port(t(x))), np.asarray(apply_jit(jm, var, x)), **TOL)
    with torch.no_grad():
        before = port(t(x))
        port.lora_b.mul_(2.0)
        after = port(t(x))
    var["params"]["lora_b"] = var["params"]["lora_b"] * 2.0
    assert not torch.equal(before, after)
    np.testing.assert_allclose(n(after), np.asarray(apply_jit(jm, var, x)), **TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_prompt_blocks_match_jax(fused):
    """Two blocks of the prompt path on a modality-major (3B, S, C) batch:
    the first without a prompt coming in, the second with the first's; the
    outputs and the carried prompts."""
    b, s, c, k = 2, 5, 64, clip_vit.PROMPT_K
    x = _normal(3 * b, s, c, seed=7)
    lp = _normal(3 * b, k, c, seed=8)
    jm = JBlock(width=c, heads=2, use_prompt=True, prompt_k=k,
                attn_implementation="pallas" if fused else "xla")
    var = random_variables(jm, x, lp, seed=7)  # with a prompt coming in: adapter_transfer too
    port = load_port(clip_vit.ResidualAttentionBlock(c, 2, dtype=F32, fused=fused, device=CPU,
                                                     generator=generator(), use_prompt=True,
                                                     first=False), var)
    jo1, jp1 = apply_jit(jm, var, x)
    jo2, jp2 = apply_jit(jm, var, jo1, jp1)
    with torch.no_grad():
        o1, p1 = port(t(x))
        o2, p2 = port(o1, p1)
    assert o1.shape == (3 * b, s, c) and p1.shape == (3 * b, k, c)
    for got, want in ((o1, jo1), (p1, jp1), (o2, jo2), (p2, jp2)):
        np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    first = clip_vit.ResidualAttentionBlock(c, 2, dtype=F32, fused=fused, device=CPU,
                                            generator=generator(), use_prompt=True)
    assert not hasattr(first, "adapter_transfer")  # JAX's first block creates none


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_adapter_block_matches_jax_and_keeps_the_fused_mlp_off(fused, monkeypatch):
    x = _normal(3, 9, 64, seed=9)
    jm = JBlock(width=64, heads=2, use_adapter=True,
                attn_implementation="pallas" if fused else "xla")
    var = random_variables(jm, x, seed=9)
    port = load_port(clip_vit.ResidualAttentionBlock(64, 2, dtype=F32, fused=fused, device=CPU,
                                                     generator=generator(), use_adapter=True),
                     var)
    calls = []
    monkeypatch.setattr(clip_vit, "fused_mlp", lambda *a: calls.append(1))
    with torch.no_grad():
        got = port(t(x))
    assert calls == []
    np.testing.assert_allclose(n(got), np.asarray(apply_jit(jm, var, x)), **TOL)


# ---------------------------------------------------------------------------
# The six configurations through make_model
# ---------------------------------------------------------------------------


@functools.cache
def _pair(case):
    cfg = _cfg(case)
    h, w = cfg.INPUT.SIZE_TEST
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, np.zeros((2, 3, h, w, 3), np.float32),
                                 np.zeros((2,), np.int32), train=False, seed=11)
    return cfg, jmodel, variables


def _images(n_img, cfg, seed):
    h, w = cfg.INPUT.SIZE_TEST
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_img, 3, h, w, 3)).astype(np.float32),
            rng.integers(0, CAMERA_NUM, n_img).astype(np.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_tuned_model_eval_matches_jax(case):
    """The eval forward through make_model, fused (the kernels' plain
    versions) and unfused, against JAX's fused forward."""
    cfg, jmodel, variables = _pair(case)
    images, cams = _images(3, cfg, seed=12)
    want = jax.jit(lambda v, x, c: jmodel.apply(v, x, c, None, None, train=False))(
        variables, images, cams)
    for fused in (True, False):
        port = load_port(make_model(_cfg(case, fused), NUM_CLASSES, CAMERA_NUM, device=CPU,
                                    generator=generator()), variables)
        with torch.no_grad():
            got = port(t(images), t(cams).long())
        np.testing.assert_allclose(n(got["embedding"]), np.asarray(want["embedding"]),
                                   err_msg=f"fused={fused}", **TOL_MODEL)
        for name, (logits, feat) in want["branches"].items():
            np.testing.assert_allclose(n(got["branches"][name][0]), np.asarray(logits),
                                       **TOL_MODEL)


def _jax_frozen(cfg, params) -> dict:
    """JAX's frozen set: the leaves whose update from JAX's own optax chain
    (all-ones gradients) is zero, as a tree of 1.0 / 0.0 shaped like theirs."""
    tx, _, _ = j_make_optimizer(cfg, params, 4)
    ones = jax.tree_util.tree_map(jnp.ones_like, params)
    updates, _ = jax.jit(tx.update)(ones, tx.init(params), params)
    return jax.tree_util.tree_map(
        lambda u: np.full(u.shape, not np.any(np.asarray(u)), np.float32), updates)


@pytest.mark.parametrize("case,vit", [("lora_qkv", False), ("lora_conv", False),
                                      ("frozen_adapter", False), ("lora_qkv", True)],
                         ids=["lora_qkv", "lora_conv", "frozen_adapter", "vit"])
def test_frozen_set_is_jaxs(case, vit):
    """The parameters make_model freezes are exactly those JAX's optax chain
    gives zero updates, and the optimizer takes the others; on the ImageNet
    ViT, the whole base."""
    cfg = _cfg(case, vit=vit)
    h, w = cfg.INPUT.SIZE_TEST
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, np.zeros((2, 3, h, w, 3), np.float32),
                                 np.zeros((2,), np.int32), train=False, seed=13)
    port = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    flags = convert_flax_variables({"params": _jax_frozen(cfg, variables["params"]),
                                    "batch_stats": variables["batch_stats"]}, port)
    frozen = {k for k, p in port.named_parameters() if not p.requires_grad}
    assert frozen == {k for k, _ in port.named_parameters() if n(flags[k]).all()}
    held = set(create_train_state(cfg, port, 4).optimizer.state)
    assert held == {k for k, _ in port.named_parameters()} - frozen
    assert frozen == {k for k, _ in port.named_parameters() if is_frozen(k)}
    base = {k for k, _ in port.named_parameters() if k.startswith("backbone.base.")}
    if vit:
        assert frozen == base
    else:
        assert frozen < base and all(("lora" in k or "adapter" in k) for k in base - frozen)
        assert "backbone.cv_embed" not in frozen


def _batches(cfg, steps=2, b=16):
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(14)
    return [(rng.standard_normal((b, 3, h, w, 3)).astype(np.float32),
             np.repeat(np.arange(b // 2), 2).astype(np.int32),
             rng.integers(0, CAMERA_NUM, b).astype(np.int32)) for _ in range(steps)]


def _jax_two_steps(case):
    """JAX's state after each of two train steps of `case` from random
    variables, and each step's loss."""
    cfg, jmodel, variables = _pair(case)
    batches = _batches(cfg)
    images, _, cams = batches[0]
    sample = types.SimpleNamespace(images=images[:2], camids=cams[:2], viewids=cams[:2] * 0)
    jstate, tx, ctx, _ = jax_state_from(cfg, jmodel, variables, sample)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
    step = j_build_train_step(cfg, jmodel, tx, ctx, donate=False)
    states, losses = [jstate], []
    for images, pids, cams in batches:
        jstate, m = step(jstate, jnp.asarray(images), jnp.asarray(pids), jnp.asarray(cams),
                         jnp.asarray(cams * 0), jax.random.PRNGKey(1))
        states.append(jstate)
        losses.append(float(m["loss"]))
    return cfg, batches, variables, states, losses


def _port_state(cfg, variables, jstate):
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator()),
                     variables)
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    state = create_train_state(cfg, port, 4)
    convert_train_state({"params": jstate.params, "batch_stats": jstate.batch_stats},
                        jstate.opt_state, state)
    return port, state


def _check_params(port, jstate, lrs, start) -> None:
    """The port's parameters and statistics against JAX's state: trainable
    ones as the training knobs' two-step test holds them (Adam moves a weight
    by about lr a step, so an element with a gradient within noise of 0 may
    stray up to that), the BatchNorm statistics as
    check_train_step holds them, frozen ones bit for bit at their start."""
    want = convert_flax_variables({"params": jstate.params,
                                   "batch_stats": jstate.batch_stats}, port)
    frozen = {k for k, p in port.named_parameters() if not p.requires_grad}
    for k, v in port.state_dict().items():
        if k in frozen:
            assert torch.equal(v, start[k]) and np.array_equal(n(want[k]), n(start[k])), k
            continue
        if k.endswith(("running_mean", "running_var")):  # as check_train_step holds them
            np.testing.assert_allclose(n(v), n(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
            continue
        d = np.abs(n(v) - n(want[k]))
        assert d.max() <= 2 * sum(lrs) + 1e-6, k
        if k.endswith("in_proj_bias"):  # the key bias: a gradient of 0 up to noise
            c = d.shape[0] // 3
            d = np.concatenate([d[:c], d[2 * c:]])
        if k == "dgaf.modal_enhance.ln.bias":
            # a shift of every sample's fused feature alike, which the head's
            # train-mode BatchNorm and the triplet distances both cancel: a
            # gradient of 0 up to noise, held to the bound only
            continue
        assert (d > 1e-6).mean() <= 1e-3, (k, d.max())


@pytest.mark.parametrize("case", list(CASES))
def test_two_train_steps_match_jax(case, no_flax_dropout):
    """Two f32 train steps from JAX's initial state carried over
    (convert_train_state, FROZEN's masked chain included): each step's loss
    and the parameters after each step; frozen ones bit-unchanged, every
    trainable one moved (LoRA, ConvLoRA, adapters, prompts, cv_embed, the
    heads).  Then one port step from JAX's state after its first step (its
    Adam moments carried) against JAX's second."""
    cfg, batches, variables, states, losses = _jax_two_steps(case)
    port, state = _port_state(cfg, variables, states[0])
    start = {k: v.clone() for k, v in port.state_dict().items()}
    step = build_host_train_step(cfg, port, state, CPU)
    lrs = []
    for i, (images, pids, cams) in enumerate(batches):
        lrs.append(state.schedule(state.step))
        out = step(t(images), t(pids).long(), t(cams).long(), t(cams * 0).long())
        np.testing.assert_allclose(n(out["loss"]), losses[i], rtol=1e-5)
        _check_params(port, states[i + 1], lrs, start)
    trainable = [k for k, p in port.named_parameters() if p.requires_grad]
    assert all(not torch.equal(port.state_dict()[k], start[k]) for k in trainable)
    assert any(("lora" in k or "adapter" in k) for k in trainable)
    assert "backbone.cv_embed" in trainable and any(k.startswith("head_") for k in trainable)
    assert bool(cfg.MODEL.FROZEN) == (len(trainable) < len(list(port.parameters())))

    port, state = _port_state(cfg, variables, states[1])
    start = {k: v.clone() for k, v in port.state_dict().items()}
    images, pids, cams = batches[1]
    out = build_host_train_step(cfg, port, state, CPU)(t(images), t(pids).long(),
                                                       t(cams).long(), t(cams * 0).long())
    np.testing.assert_allclose(n(out["loss"]), losses[1], rtol=1e-5)
    _check_params(port, states[2], [state.schedule(1)], start)


def test_prompt_on_another_backbone_raises_as_jax_does():
    cfg = _cfg("prompt", vit=True)
    h, w = cfg.INPUT.SIZE_TEST
    with pytest.raises(NotImplementedError, match="only defined for the CLIP backbone"):
        j_make_model(cfg, NUM_CLASSES, CAMERA_NUM).init(
            jax.random.PRNGKey(0), np.zeros((1, 3, h, w, 3), np.float32),
            np.zeros((1,), np.int32), train=False)
    with pytest.raises(NotImplementedError, match="only defined for the CLIP backbone"):
        make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())


def test_remat_carries_the_prompt():
    """REMAT_BACKBONE with the prompts: the loss and every gradient of the
    run without remat, bit for bit but for the SIE embedding's, within an
    ulp (both draw SDTPS's dropout from a generator seeded alike)."""
    from demo2_tpu_torch.engine.train import loss_and_grads
    from demo2_tpu_torch.losses import losses as tl

    images, pids, cams = _batches(_cfg("prompt"), steps=1)[0]
    runs = []
    for remat in (False, True):
        cfg = _cfg("prompt", remat=remat)
        port = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
        with torch.no_grad():
            for k, p in port.named_parameters():
                if k.endswith("adapter_prompts"):
                    p.copy_(torch.randn(p.shape, generator=generator(3)) * 0.1)
        runs.append(loss_and_grads(cfg, port, tl.make_loss_fn(cfg, NUM_CLASSES), t(images),
                                   t(pids).long(), t(cams).long(), generator(5)))
    (loss, _, grads), (r_loss, _, r_grads) = runs
    assert torch.equal(loss, r_loss) and set(grads) == set(r_grads)
    unequal = {k for k in grads if not torch.equal(grads[k], r_grads[k])}
    # the SIE rows gather the CLS gradient per sample; the recomputed graph
    # may add a camera's rows in another order: an ulp, not bit for bit
    assert unequal <= {"backbone.cv_embed"}, unequal
    for k in unequal:
        assert (grads[k] - r_grads[k]).abs().max() <= 1e-6 * grads[k].abs().max(), k
    assert grads["backbone.base.resblocks.1.adapter_transfer.up.weight"].abs().max() > 0
