"""The port's ImageNet ViT slice against the JAX package on the CPU.

The exact GELU, drop path (fed JAX's own draw), the biased patch conv, the
ViT block, the whole ImageNetViT (SIE by camera, by view and by both; an
overlapping stride), PIFE for each admitted ImageNet type, and DeMo (SDTPS +
DGAF v3) on vit_base_patch16_224: the eval embedding, the train-mode
forward and one whole f32 train step against JAX's build_train_step (loss,
every grad, post-Adam parameters and BatchNorm statistics).  Then the
converters: a JAX ImageNet ViT DeMo's variables and train state, and a timm
checkpoint against convert_imagenet_vit.  Every flax leaf is a seeded random
value, loaded into the port through the converter; inputs are seeded numpy
arrays.  Sizes are small (depth 1-2, 64x32 images) at the ImageNet width of
768 that JAX's feat_dim_for fixes.
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
from demo2_tpu.models import vit as jvit
from demo2_tpu.models.pife import PIFE as JPIFE
from demo2_tpu.models.pife import patch_grid_for as j_patch_grid_for
from demo2_tpu.serving import FeatureExtractor as JFeatureExtractor
from demo2_tpu.utils.converters import convert_imagenet_vit
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.engine.train import loss_and_grads
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.models import make_model, vit
from demo2_tpu_torch.models.clip_vit import PatchConv
from demo2_tpu_torch.models.pife import PIFE, patch_grid_for
from demo2_tpu_torch.ops.activations import gelu
from demo2_tpu_torch.serving import FeatureExtractor
from demo2_tpu_torch.utils.converters import (convert_flax_variables, convert_train_state,
                                              load_imagenet_vit_pretrained)
from torch_port_helpers import (CPU, apply_jit, generator, jax_state_from, load_port, n,
                                random_variables, t)

# f32 on both sides: only the summation order differs.
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32


def _normal(*shape, seed=0, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


# ---------------------------------------------------------------------------
# Pieces: exact GELU, drop path, the biased patch conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_gelu_matches_jax(dtype):
    x = _normal(6, 40, seed=1, std=3.0)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, getattr(jnp, dtype)), approximate=False),
                      np.float32)
    got = gelu(t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: the same formula, but torch evaluates erfc in f32 and rounds
    # once, XLA rounds after each bf16 op: one bf16 ulp apart at most.
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -8)
    np.testing.assert_allclose(n(got), want, **tol)


def test_drop_path_matches_jax_given_its_mask():
    x = _normal(8, 5, 12, seed=2)
    rate, rng = 0.3, jax.random.PRNGKey(4)
    want = jvit.drop_path(jnp.asarray(x), rate, False, rng)
    mask = np.asarray(jax.random.bernoulli(rng, 1.0 - rate, (8, 1, 1)))
    got = vit.drop_path(t(x), rate, train=True, mask=t(mask))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert 0 < mask.sum() < 8  # the draw drops some samples and keeps others
    # At eval, or at rate 0, it is the identity; drawn, it keeps about 1 - rate.
    assert torch.equal(vit.drop_path(t(x), rate, train=False), t(x))
    assert torch.equal(vit.drop_path(t(x), 0.0, train=True), t(x))
    out = vit.drop_path(torch.ones(4000, 3), rate, train=True, generator=generator(3))
    kept = (out != 0).all(-1)
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.03
    assert not out[~kept].any()  # whole samples are dropped
    np.testing.assert_allclose(n(out[kept]), 1 / (1 - rate), rtol=1e-6)


def test_patch_conv_with_bias_matches_flax_conv():
    jm = flax.linen.Conv(24, kernel_size=(16, 16), strides=(12, 12), padding="VALID")
    x = _normal(2, 40, 28, 3, seed=3)
    variables = random_variables(jm, x)
    assert variables["params"]["bias"].shape == (24,)
    want = apply_jit(jm, variables, jnp.asarray(x))
    port = load_port(PatchConv(24, 16, (12, 12), dtype=F32, device=CPU, generator=generator(),
                               bias=True), variables)
    got = port(t(x))
    np.testing.assert_allclose(n(got), np.asarray(want).reshape(2, -1, 24), **TOL)


# ---------------------------------------------------------------------------
# ViTBlock, ImageNetViT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,qkv_bias,qk_scale", [
    ("xla", True, None), ("pallas", True, None), ("pallas", False, 64 ** -0.5 / 2)])
def test_vit_block_matches_jax(impl, qkv_bias, qk_scale):
    x = _normal(3, 9, 128, seed=4)
    kw = dict(mlp_ratio=4.0, qkv_bias=qkv_bias, qk_scale=qk_scale, drop_path_rate=0.1)
    jm = jvit.ViTBlock(2, implementation=impl, **kw)
    variables = random_variables(jm, x, seed=4)
    port = load_port(vit.ViTBlock(128, 2, implementation=impl, dtype=F32, device=CPU,
                                  generator=generator(), **kw), variables)
    want = apply_jit(jm, variables, jnp.asarray(x))
    np.testing.assert_allclose(n(port(t(x))), np.asarray(want), **TOL)
    # Train mode with nothing random active (rates 0) is the eval function.
    jm0 = jvit.ViTBlock(2, implementation=impl, mlp_ratio=4.0, qkv_bias=qkv_bias,
                        qk_scale=qk_scale)
    want_train = jax.jit(lambda v, a: jm0.apply(v, a, False))(variables, jnp.asarray(x))
    port.drop_path_rate = 0.0
    np.testing.assert_allclose(n(port(t(x), train=True)), np.asarray(want_train), **TOL)


CAMS, VIEWS = 4, 3


def _vit_pair(camera, view, img_size=(64, 32), stride=(16, 16), depth=2):
    kw = dict(img_size=img_size, stride_size=stride, embed_dim=768, depth=depth, num_heads=12,
              camera=camera, view=view, sie_xishu=1.5, drop_path_rate=0.1)
    jm = jvit.ImageNetViT(attn_implementation="pallas", **kw)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, *img_size, 3)).astype(np.float32)
    cams = rng.integers(0, CAMS, 3).astype(np.int32)
    views = rng.integers(0, VIEWS, 3).astype(np.int32)
    variables = random_variables(jm, x, cams, views, seed=5)
    port = load_port(vit.ImageNetViT(attn_implementation="pallas", dtype=F32, device=CPU,
                                     generator=generator(), **kw), variables)
    return jm, variables, port, x, cams, views


@pytest.mark.parametrize("camera,view", [(0, 0), (CAMS, 0), (0, VIEWS), (CAMS, VIEWS)],
                         ids=["no_sie", "camera", "view", "camera_x_view"])
def test_imagenet_vit_matches_jax(camera, view):
    jm, variables, port, x, cams, views = _vit_pair(camera, view)
    assert ("sie_embed" in variables["params"]) == bool(camera or view)
    if camera and view:
        assert variables["params"]["sie_embed"].shape == (CAMS * VIEWS, 1, 768)
    want = apply_jit(jm, variables, *map(jnp.asarray, (x, cams, views)))
    got = port(t(x), t(cams).long(), t(views).long())
    assert got.shape == (3, 4 * 2 + 1, 768)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_imagenet_vit_overlapping_stride_matches_jax():
    """Stride 12 on 252x124 (tests/test_models.py:259-268): the grid is
    (H - 16) // 12 + 1 per side, 20 x 10, not H // 12."""
    jm, variables, port, x, cams, views = _vit_pair(CAMS, 0, (252, 124), (12, 12), depth=1)
    assert port.grid == (20, 10) == jm.grid
    want = apply_jit(jm, variables, *map(jnp.asarray, (x, cams, views)))
    got = port(t(x), t(cams).long(), t(views).long())
    assert got.shape == (3, 201, 768)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("tt,stride", [("vit_base_patch16_224", (16, 16)),
                                       ("t2t_vit_t_14", (16, 16)), ("resnet50", (16, 16)),
                                       ("deit_small_patch16_224", (12, 12))])
def test_patch_grid_for_matches_jax(tt, stride):
    for size in ((256, 128), (252, 124), (64, 32)):
        assert patch_grid_for(tt, size, stride) == j_patch_grid_for(tt, size, stride)


# ---------------------------------------------------------------------------
# PIFE, each admitted ImageNet type
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tt,stride", [
    pytest.param(tt, (16, 16), id=tt)
    for tt in ("vit_base_patch16_224", "deit_base_patch16_224", "vit_small_patch16_224",
               "deit_small_patch16_224", "swin_small_patch16_224")
] + [pytest.param("vit_small_patch16_224", (12, 12), id="vit_small_patch16_224-stride12")])
def test_pife_imagenet_types_match_jax(tt, stride):
    """Each ImageNet type, and vit_small (heads of 96) at the overlapping
    stride 12 (5 x 2 patches at 64x32)."""
    kw = dict(transformer_type=tt, img_size=(64, 32), stride_size=stride, camera_num=CAMS,
              view_num=VIEWS, sie_camera=True, sie_view=True, sie_coe=1.5, drop_path=0.1,
              depth_override=1, width_override=-1, heads_override=-1)
    jm = JPIFE(attn_implementation="pallas", **kw)
    rng = np.random.default_rng(6)
    images = rng.standard_normal((2, 3, 64, 32, 3)).astype(np.float32)
    cams, views = rng.integers(0, CAMS, 2), rng.integers(0, VIEWS, 2)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32)
    variables = random_variables(jm, images, cams, views, mask, seed=6)
    port = load_port(PIFE(fused=True, dtype=F32, device=CPU, generator=generator(), **kw),
                     variables)
    assert port.feat_dim == jm.feat_dim
    want_p, want_g = apply_jit(jm, variables, *map(jnp.asarray, (images, cams, views, mask)))
    got_p, got_g = port(t(images), t(cams).long(), t(views).long(), t(mask))
    gh, gw = jm.patch_grid
    assert got_g.shape == (3, 2, jm.feat_dim) and got_p.shape == (3, 2, gh * gw, jm.feat_dim)
    np.testing.assert_allclose(n(got_p), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(n(got_g), np.asarray(want_g), **TOL)


# ---------------------------------------------------------------------------
# DeMo on vit_base_patch16_224
# ---------------------------------------------------------------------------

NUM_CLASSES = 8


def _cfg(tt="vit_base_patch16_224", **model):
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.MODEL.TRANSFORMER_TYPE = tt
    cfg.TPU.BACKBONE_WIDTH = -1  # the width override is CLIP-only (test_models.py:202-210)
    cfg.TPU.BACKBONE_HEADS = -1
    cfg.TPU.USE_FLASH_ATTENTION = True
    cfg.MODEL.SDTPS_CROSS_ATTN_TYPE = "attention"
    cfg.MODEL.SDTPS_SPARSE_RATIO = 0.7
    cfg.MODEL.SIE_VIEW = True
    cfg.MODEL.DROP_PATH = 0.0  # its draws are JAX's own; tested above with JAX's mask
    for k, v in model.items():
        setattr(cfg.MODEL, k, v)
    return cfg


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _batch(cfg, b, seed):
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 3, h, w, 3)).astype(np.float32),
            np.repeat(np.arange(b // 2), 2).astype(np.int32),
            rng.integers(0, CAMS, b).astype(np.int32), rng.integers(0, VIEWS, b).astype(np.int32))


@functools.cache
def _demo_case():
    """The ViT DeMo's inputs and random variables, and JAX's train step from
    them: (cfg, batch, jmodel, variables, loss, grads, state after the step,
    metrics).  Callers turn flax's dropout off."""
    cfg = _cfg()
    cfg.freeze()
    images, pids, cams, views = batch = _batch(cfg, 8, seed=7)
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMS, VIEWS)
    variables = random_variables(jmodel, images[:2], cams[:2], views[:2], train=False, seed=7)
    sample = types.SimpleNamespace(images=images[:2], camids=cams[:2], viewids=views[:2])
    jstate, tx, ctx, _ = jax_state_from(cfg, jmodel, variables, sample)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
    jargs = tuple(map(jnp.asarray, batch))
    loss_fn = jl.make_loss_fn(cfg, NUM_CLASSES)

    def j_loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jargs[0], jargs[2], jargs[3], None, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        wts = jl.branch_weights(cfg, out["branches"].keys())
        return sum(wts[k] * loss_fn(lg, f, jargs[1]) for k, (lg, f) in out["branches"].items())

    j_loss_value, j_grads = jax.jit(jax.value_and_grad(j_loss))(variables["params"])
    new_jstate, metrics = j_build_train_step(cfg, jmodel, tx, ctx, donate=False)(
        jstate, *jargs, jax.random.PRNGKey(1))
    return cfg, batch, jmodel, variables, float(j_loss_value), j_grads, new_jstate, metrics


def _port_model(cfg, variables):
    port = load_port(make_model(cfg, NUM_CLASSES, CAMS, VIEWS, device=CPU,
                                generator=generator()), variables)
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    return port


@pytest.mark.parametrize("miss", [(1.0, 1.0, 1.0), (1.0, 0.0, 0.0)], ids=["None", "nt"])
def test_demo_vit_eval_matches_jax(miss, no_flax_dropout):
    cfg, (images, _, cams, views), jmodel, variables = _demo_case()[:4]
    port = _port_model(cfg, variables)
    mask = np.asarray(miss, np.float32)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, *map(jnp.asarray, (images, cams, views, mask)))
    with torch.no_grad():
        got = port(t(images), t(cams).long(), t(views).long(), t(mask))
    assert got["embedding"].shape == (8, 3 * 768)
    np.testing.assert_allclose(n(got["embedding"]), np.asarray(want["embedding"]), **TOL)
    for name, (logits, feat) in want["branches"].items():
        np.testing.assert_allclose(n(got["branches"][name][0]), np.asarray(logits), **TOL)


def test_demo_vit_train_forward_matches_jax(no_flax_dropout):
    cfg, (images, _, cams, views), jmodel, variables = _demo_case()[:4]
    port = _port_model(cfg, variables)
    want, mutated = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, None, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(variables, *map(jnp.asarray, (images, cams, views)))
    with torch.no_grad():
        got = port(t(images), t(cams).long(), t(views).long(), train=True,
                   generator=generator(1))
    for name, (logits, feat) in want["branches"].items():
        np.testing.assert_allclose(n(got["branches"][name][0]), np.asarray(logits), **TOL)
        np.testing.assert_allclose(n(got["branches"][name][1]), np.asarray(feat), **TOL)
    np.testing.assert_allclose(n(port.head_dgaf.bottleneck.bn.running_mean),
                               np.asarray(mutated["batch_stats"]["head_dgaf"]["bottleneck"]["bn"]
                                          ["mean"]), **TOL)


def test_one_vit_train_step_matches_jax(no_flax_dropout):
    cfg, (images, pids, cams, views), _, variables, j_loss, j_grads, new_jstate, metrics = \
        _demo_case()
    np.testing.assert_allclose(float(metrics["loss"]), j_loss, rtol=1e-6)
    port = _port_model(cfg, variables)
    loss, acc, grads = loss_and_grads(cfg, port, tl.make_loss_fn(cfg, NUM_CLASSES), t(images),
                                      t(pids).long(), t(cams).long(), None, t(views).long())
    np.testing.assert_allclose(n(loss), j_loss, rtol=1e-5)
    np.testing.assert_allclose(n(acc), float(metrics["acc"]))
    want_grads = convert_flax_variables({"params": j_grads, "batch_stats": variables["batch_stats"]},
                                        port)
    assert set(grads) == {k for k, _ in port.named_parameters()}
    assert any(k.startswith("backbone.base.blocks.1.attn.qkv") for k in grads)
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
    # within summation noise of 0 may move by any amount up to lr.  Elements
    # are held to 1e-6, and one may stray (up to that bound) only where JAX's
    # gradient is small: below 1e-3 of the tensor's largest plus 1e-5 of the
    # model's, ten times the gradient check's absolute tolerance.  (JAX's
    # own step takes its gradient from another compiled program than
    # value_and_grad above, with its own summation noise.)
    lr = state.schedule(0)
    for k, v in port.state_dict().items():
        d = np.abs(n(v) - n(want[k]))
        assert d.max() <= 2 * lr + 1e-6, k
        if k in grads:
            w = np.abs(n(want_grads[k]))
            assert np.all(w[d > 1e-6] <= 1e-3 * w.max() + 1e-5 * top), (k, d.max())
        else:  # BatchNorm statistics
            assert d.max() <= 1e-6, k


@pytest.mark.parametrize("tt,width", [("deit_small_patch16_224", -1),
                                      ("swin_small_patch16_224", -1),
                                      ("vit_base_patch16_224", 384)])
def test_demo_refuses_what_jax_cannot_run(tt, width):
    """feat_dim_for gives 768 for every ImageNet type, whatever the backbone
    width: JAX builds SDTPS / DGAF at 768 and its forward fails on 384-wide
    tokens.  The port refuses the same configurations."""
    cfg = _cfg(tt)
    cfg.TPU.BACKBONE_WIDTH = width
    cfg.TPU.BACKBONE_DEPTH = 1
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMS)
    x = np.zeros((2, 3, 64, 32, 3), np.float32)
    with pytest.raises(ValueError):
        jmodel.init({"params": jax.random.PRNGKey(0)}, x, np.zeros(2, np.int32), train=False)
    with pytest.raises(ValueError, match="feat_dim"):
        make_model(cfg, NUM_CLASSES, CAMS, device=CPU, generator=generator())


def test_feature_extractor_on_vit_matches_jax():
    """JAX's extractor passes no view ids, so the model has no view SIE."""
    cfg = _cfg(SIE_VIEW=False)
    cfg.TPU.BACKBONE_DEPTH = 1
    cfg.freeze()
    images, _, cams, _ = _batch(cfg, 5, seed=10)
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMS)
    variables = random_variables(jmodel, images[:2], cams[:2], train=False, seed=10)
    port = load_port(make_model(cfg, NUM_CLASSES, CAMS, device=CPU, generator=generator()),
                     variables)
    jfx = JFeatureExtractor(cfg, jmodel, jax.tree.map(jnp.asarray, variables), batch_size=4)
    fx = FeatureExtractor(cfg, port, device=CPU, batch_size=4)
    for n_req in (0, 1, 5):
        got = fx.extract(images[:n_req], cams[:n_req], miss="nt")
        want = jfx.extract(images[:n_req], cams[:n_req], miss="nt")
        assert got.shape == want.shape == (n_req, 3 * 768)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------


def test_converter_carries_jax_vit_train_state(no_flax_dropout):
    cfg, _, _, variables, _, _, new_jstate, _ = _demo_case()
    port = _port_model(cfg, variables)
    sd = convert_flax_variables(variables, port)
    p = variables["params"]["backbone"]["base"]
    np.testing.assert_array_equal(n(sd["backbone.base.blocks.1.attn.qkv.weight"]),
                                  p["blocks_1"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(n(sd["backbone.base.patch_embed_proj.weight"]),
                                  p["patch_embed_proj"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(n(sd["backbone.base.sie_embed"]), p["sie_embed"])
    state = create_train_state(cfg, port, 4)
    convert_train_state({"params": new_jstate.params, "batch_stats": new_jstate.batch_stats},
                        new_jstate.opt_state, state)
    assert state.step == 1
    k = "backbone.base.blocks.0.mlp.fc1.weight"
    np.testing.assert_array_equal(
        n(state.model.state_dict()[k]),
        np.asarray(new_jstate.params["backbone"]["base"]["blocks_0"]["mlp"]["fc1"]["kernel"]).T)
    assert float(state.optimizer.state[k]["nu"].abs().sum()) > 0


def _timm_state_dict(depth, qkv_bias, seed):
    """A synthetic timm vit_base_patch16_224 state dict: a 14x14 grid."""
    rng = np.random.default_rng(seed)
    c = 768
    f = lambda *shape: (rng.standard_normal(shape) * 0.05).astype(np.float32)
    sd = {"patch_embed.proj.weight": f(c, 3, 16, 16), "patch_embed.proj.bias": f(c),
          "cls_token": f(1, 1, c), "pos_embed": f(1, 1 + 14 * 14, c), "norm.weight": 1 + f(c),
          "norm.bias": f(c), "head.weight": f(1000, c), "head.bias": f(1000)}
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": 1 + f(c), p + "norm1.bias": f(c),
                   p + "norm2.weight": 1 + f(c), p + "norm2.bias": f(c),
                   p + "attn.qkv.weight": f(3 * c, c), p + "attn.proj.weight": f(c, c),
                   p + "attn.proj.bias": f(c), p + "mlp.fc1.weight": f(4 * c, c),
                   p + "mlp.fc1.bias": f(4 * c), p + "mlp.fc2.weight": f(c, 4 * c),
                   p + "mlp.fc2.bias": f(c)})
        if qkv_bias:
            sd[p + "attn.qkv.bias"] = f(3 * c)
    return sd


def test_load_imagenet_vit_pretrained_matches_convert_imagenet_vit():
    """A 224x224 checkpoint (14x14 grid) into a 256x128 model (16x8): the
    positional embedding resized by un-antialiased bilinear interpolation."""
    sd = _timm_state_dict(depth=2, qkv_bias=True, seed=8)
    jparams = convert_imagenet_vit(sd, 16, 8)
    port = vit.ImageNetViT(img_size=(256, 128), depth=2, dtype=F32, device=CPU,
                           generator=generator())
    loaded = load_imagenet_vit_pretrained(port, sd)
    assert "head.weight" not in loaded and "blocks.1.attn.qkv.bias" in loaded
    want = convert_flax_variables({"params": jparams}, port)
    got = port.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        # pos_embed: F.interpolate's one-pass blend vs the numpy mirror's two
        # passes, f32 rounding apart; every other tensor is copied exactly.
        np.testing.assert_allclose(n(got[k]), n(v), rtol=1e-6, atol=1e-7, err_msg=k)
    x = _normal(1, 256, 128, 3, seed=9)
    jm = jvit.ImageNetViT(img_size=(256, 128), depth=2)
    want_out = apply_jit(jm, {"params": jparams}, jnp.asarray(x))
    np.testing.assert_allclose(n(port(t(x))), np.asarray(want_out), **TOL)
    sd["blocks.0.attn.qkv.weight"] = sd["blocks.0.attn.qkv.weight"][:, :10]
    with pytest.raises(ValueError, match="blocks.0.attn.qkv.weight"):
        load_imagenet_vit_pretrained(port, sd)
