"""The DeMoBeiyong cascade (DeMoLegacy) against the JAX package on the CPU:
SACR, MultiModalSACR v1 / v2 (models/sacr.py) at the real 16 x 8 patch grid
of 256 x 128 images with a narrow width, Trimodal-LIF (models/lif.py) with
its resizes, quality targets, loss and reweighting, then the five
configs/ files that build DeMoLegacy through make_model at apply_tiny's
widths, and one whole f32 train step of DeMo_SACR_SDTPS_LIF.yml against
JAX's build_train_step.  Every flax leaf is a seeded random value loaded
into the port through the converter; inputs are seeded numpy arrays given
to both.  Tolerance: rtol = atol = 1e-5 in f32; bf16 results are held
against the f32 forward, no further from it than JAX's bf16 results.
"""

import functools

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_tiny
from demo2_tpu.models import lif as jlif
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.models import sacr as jsacr
from demo2_tpu_torch.models import lif as tlif
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.models import sacr as tsacr
from demo2_tpu_torch.utils.converters import convert_flax_variables
from torch_port_helpers import (CPU, apply_jit, apply_train, assert_bf16_as_close_as_jax,
                                check_stats, check_train_step, generator, jax_train_case,
                                load_port, n, random_variables, t)

TOL = dict(rtol=1e-5, atol=1e-5)
NUM_CLASSES, CAMERA_NUM = 8, 4
GRID = (16, 8)  # the patch grid of 256 x 128 at stride 16: dilations 2-4 see real tokens
C, B = 128, 2   # ECA's kernel is 5 at 128 channels (3 below 32)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SACR_CLASSES = ("SACR", "MultiModalSACR", "MultiModalSACRv2")


def _normal(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_eca_kernel_size_is_the_jax_packages():
    for c in (1, 8, 32, 64, 128, 512, 768, 2048):
        assert tsacr.eca_kernel_size(c) == jsacr.eca_kernel_size(c), c
    assert [tsacr.eca_kernel_size(c) for c in (128, 512)] == [5, 5]


@functools.cache
def _sacr_case(name, dtype):
    jdt, tdt = DTYPES[dtype]
    tokens = _normal(3, B, GRID[0] * GRID[1], C, seed=1)
    jm = getattr(jsacr, name)(token_dim=C, height=GRID[0], width=GRID[1], dtype=jdt)
    variables = random_variables(jm, tokens, use_running_average=True, seed=2)
    return tokens, jm, variables, tdt


def _run(jm, variables, x, train):
    """(output, updated batch_stats or None) of a flax module that takes
    `use_running_average`."""
    if train:
        return apply_train(jm, variables, x, use_running_average=False)
    return apply_jit(jm, variables, x, use_running_average=True), None


def _sacr_port(name, variables, tdt):
    port = getattr(tsacr, name)(C, *GRID, (2, 3, 4), dtype=tdt, device=CPU,
                                generator=generator())
    return load_port(port, variables)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SACR_CLASSES)
def test_sacr_modules_match_jax(name, dtype, train):
    tokens, jm, variables, tdt = _sacr_case(name, dtype)
    port = _sacr_port(name, variables, tdt)
    x = jnp.asarray(tokens, DTYPES[dtype][0])
    want, stats = _run(jm, variables, x, train)
    got = port(t(tokens).to(tdt), train)
    assert got.shape == tokens.shape and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    else:
        f32 = _sacr_case(name, "float32")[1]
        assert_bf16_as_close_as_jax(got, want, _run(f32, variables, tokens, train)[0])
    if train:
        # 3 + 3 conv BatchNorms (+ cross_modal's in v1), statistics in f32.
        check_stats(port, variables, stats, TOL if dtype == "float32" else
                    dict(rtol=2e-2, atol=2e-2))


def test_sacr_dilations_reach_the_grid():
    """Each atrous branch changes the output on the 16 x 8 grid: a wrong
    dilation would not pass unseen, as it would on a 2 x 1 grid."""
    tokens, _, variables, tdt = _sacr_case("SACR", "float32")
    port = _sacr_port("SACR", variables, tdt)
    base = n(port(t(tokens)))
    for i in range(3):
        conv = getattr(port.core, f"atrous_{i}").conv
        conv.dilation = conv.padding = conv.dilation + 1
        assert not np.allclose(n(port(t(tokens))), base, **TOL), i
        conv.dilation = conv.padding = conv.dilation - 1


def test_converter_fills_the_sacr_trees():
    for name in SACR_CLASSES:
        _, _, variables, tdt = _sacr_case(name, "float32")
        port = _sacr_port(name, variables, tdt)
        sd = convert_flax_variables(variables, port)
        p = variables["params"]["core"]
        # ECA's 1-D conv over the channels: flax (k, 1, 1) -> Conv1d (1, 1, k).
        np.testing.assert_array_equal(n(sd["core.channel_attn.weight"]),
                                      p["channel_attn"]["kernel"].transpose(2, 1, 0))
        assert sd["core.channel_attn.weight"].shape == (1, 1, 5)
        np.testing.assert_array_equal(n(sd["core.atrous_1.conv.weight"]),
                                      p["atrous_1"]["conv"]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(n(sd["core.fusion.bn.running_var"]),
                                      variables["batch_stats"]["core"]["fusion"]["bn"]["var"])
        if name == "MultiModalSACRv2":
            np.testing.assert_array_equal(n(sd["modal_embed"]), variables["params"]["modal_embed"])
            np.testing.assert_array_equal(
                n(sd["cross_modal_attn.in_proj_weight"]),
                variables["params"]["cross_modal_attn"]["in_proj_kernel"].T)
        flat = dict(flax.traverse_util.flatten_dict(variables))
        del flat[("params", "core", "channel_attn", "kernel")]
        with pytest.raises(ValueError, match="no leaf filled"):
            convert_flax_variables(flax.traverse_util.unflatten_dict(flat), port)


# ---------------------------------------------------------------------------
# Trimodal-LIF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trimodal_lif_matches_jax(dtype, train):
    jdt, tdt = DTYPES[dtype]
    images = _normal(B, 3, 64, 32, 3, seed=3)
    jm = jlif.TrimodalLIF(dtype=jdt)
    variables = random_variables(jm, images, use_running_average=True, seed=4)
    port = load_port(tlif.TrimodalLIF(dtype=tdt, device=CPU, generator=generator()), variables)
    x = jnp.asarray(images, jdt)
    want, stats = _run(jm, variables, x, train)
    got = port(t(images).to(tdt), train)
    assert got.shape == (3, B, 8, 4, 1) and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    else:
        assert_bf16_as_close_as_jax(got, want, _run(jlif.TrimodalLIF(), variables, images,
                                                    train)[0])
    if train:
        check_stats(port, variables, stats, TOL if dtype == "float32" else
                    dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("shape,size", [
    ((6, 32, 16, 1), (16, 8)),    # quality maps of 256 x 128 to the patch grid
    ((2, 256, 128, 1), (32, 16)),  # full images to H/8 x W/8
    ((6, 8, 4, 1), (4, 2)),       # apply_tiny's maps to its grid
    ((2, 7, 5, 3), (16, 8)),      # growing, odd sizes
])
def test_resize_bilinear_is_the_jax_packages(shape, size):
    x = _normal(*shape, seed=5)
    want = jlif._resize_bilinear(jnp.asarray(x), size)
    got = tlif._resize_bilinear(t(x), size)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_quality_targets_and_lif_loss_match_jax():
    """At 256 x 128, in f32 from f32 images, the maps at H/8 x W/8."""
    images = _normal(B, 3, 256, 128, 3, seed=6)
    target = (32, 16)
    for name, i in (("rgb_quality", 0), ("nir_quality", 1), ("tir_quality", 2)):
        want = getattr(jlif, name)(jnp.asarray(images[:, i]), target)
        got = getattr(tlif, name)(t(images[:, i]), target)
        assert got.shape == (B, *target, 1)
        np.testing.assert_allclose(n(got), np.asarray(want), err_msg=name, **TOL)
    qmaps = np.abs(_normal(3, B, *target, 1, seed=7))
    want = jlif.lif_loss(jnp.asarray(qmaps), jnp.asarray(images))
    np.testing.assert_allclose(n(tlif.lif_loss(t(qmaps), t(images))), float(want), rtol=1e-5)
    # bf16 maps and images: the loss still runs in f32 (on the bf16 values).
    qb, ib = t(qmaps).bfloat16(), t(images).bfloat16()
    want = jlif.lif_loss(jnp.asarray(qmaps, jnp.bfloat16), jnp.asarray(images, jnp.bfloat16))
    got = tlif.lif_loss(qb, ib)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lif_reweight_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    patches = _normal(3, B, GRID[0] * GRID[1], 16, seed=8)
    qmaps = np.abs(_normal(3, B, 32, 16, 1, seed=9))
    temperature = 0.4 * 10.0  # LIF_BETA * 10, as DeMoLegacy passes it
    want = jlif.lif_reweight(jnp.asarray(patches, jdt), jnp.asarray(qmaps, jdt), GRID,
                             temperature)
    got = tlif.lif_reweight(t(patches).to(tdt), t(qmaps).to(tdt), GRID, temperature)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    else:  # JAX resizes in bf16 arithmetic, torch's interpolate accumulates in f32
        ref = jlif.lif_reweight(jnp.asarray(patches), jnp.asarray(qmaps), GRID, temperature)
        assert_bf16_as_close_as_jax(got, want, ref)


# ---------------------------------------------------------------------------
# DeMoLegacy through make_model
# ---------------------------------------------------------------------------

CASES = {  # id: (YAML file under configs/RGBNT201/, MODEL overrides)
    "SACR_SDTPS": ("DeMo_SACR_SDTPS.yml", {}),
    "SACR_SDTPS_LIF": ("DeMo_SACR_SDTPS_LIF.yml", {}),
    "LIF": ("DeMo_LIF.yml", {}),
    "MultiModalSACR_SDTPS_DGAF": ("DeMo_MultiModalSACR_SDTPS_DGAF.yml", {}),
    "MultiModalSACR_SDTPS_DGAF_v2": ("DeMo_MultiModalSACR_SDTPS_DGAF_v2.yml", {}),
    "SACR-hdm-direct0": ("DeMo_SACR_SDTPS.yml", {"HDM": True, "ATM": True, "HEAD": 4,
                                                 "DIRECT": 0}),
    "LIF-globals-direct0": ("DeMo_LIF.yml", {"USE_SDTPS": False, "DIRECT": 0}),
    "SACR-dgaf_v1-global_local": ("DeMo_SACR_SDTPS.yml", {"USE_SDTPS": False, "USE_DGAF": True,
                                                          "DGAF_VERSION": "v1"}),
}
# The branch names in the JAX package's order: the moe head first.
BRANCHES = {
    "SACR_SDTPS": ["sdtps"],
    "LIF": ["sdtps"],
    "MultiModalSACR_SDTPS_DGAF": ["dgaf"],
    "SACR-hdm-direct0": ["moe", "sdtps", "ori_r", "ori_n", "ori_t"],
    "LIF-globals-direct0": ["ori_r", "ori_n", "ori_t"],
    "SACR-dgaf_v1-global_local": ["dgaf"],
}


def _cfg(case):
    path, model = CASES[case]
    cfg = get_cfg_defaults()
    cfg.merge_from_file(f"configs/RGBNT201/{path}")
    apply_tiny(cfg)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DATA_CACHE = "device"
    for k, v in model.items():
        setattr(cfg.MODEL, k, v)
    return cfg.freeze()


@functools.cache
def _pair(case):
    cfg = _cfg(case)
    h, w = cfg.INPUT.SIZE_TEST
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, np.zeros((2, 3, h, w, 3), np.float32),
                                 np.zeros((2,), np.int32), train=False, seed=3)
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), variables)
    order = []

    def apply(v, x, c, m):
        out = jmodel.apply(v, x, c, None, m, train=False)
        order.append(list(out["branches"]))  # the model's own order, read at trace time
        return out

    return cfg, jmodel, variables, port, jax.jit(apply), order


@pytest.mark.parametrize("case", list(CASES))
def test_legacy_configs_match_jax(case):
    cfg, _, variables, port, japply, order = _pair(case)
    assert type(port).__name__ == "DeMoLegacy"
    h, w = cfg.INPUT.SIZE_TEST
    rng = np.random.default_rng(1)
    images = rng.standard_normal((3, 3, h, w, 3)).astype(np.float32)
    cams = rng.integers(0, CAMERA_NUM, 3).astype(np.int32)
    for mask in (np.ones(3, np.float32), np.array([1.0, 0.0, 0.0], np.float32)):
        want = japply(variables, images, cams, mask)
        with torch.no_grad():
            got = port(t(images), t(cams).long(), None, t(mask))
        assert list(got["branches"]) == order[0] == BRANCHES.get(case, order[0])
        assert got["embedding"].shape == (3, port.embed_dim) == want["embedding"].shape
        assert got["aux_loss"] == {} == dict(want["aux_loss"])
        np.testing.assert_allclose(n(got["embedding"]), np.asarray(want["embedding"]), **TOL)
        for name, (logits, feat) in want["branches"].items():
            np.testing.assert_allclose(n(got["branches"][name][0]), np.asarray(logits),
                                       err_msg=name, **TOL)
            np.testing.assert_allclose(n(got["branches"][name][1]), np.asarray(feat),
                                       err_msg=name, **TOL)


def test_legacy_modules_by_config():
    """Each file builds the stage it names, under the JAX package's names."""
    stages = {"SACR_SDTPS": ("sacr", tsacr.SACR), "LIF": ("lif", tlif.TrimodalLIF),
              "MultiModalSACR_SDTPS_DGAF": ("multimodal_sacr", tsacr.MultiModalSACR),
              "MultiModalSACR_SDTPS_DGAF_v2": ("multimodal_sacr", tsacr.MultiModalSACRv2)}
    for case, (attr, cls) in stages.items():
        port = _pair(case)[3]
        assert type(getattr(port, attr)) is cls, case
        assert {k.split(".")[0] for k in port.state_dict()} == set(
            _pair(case)[2]["params"]), case
    port = _pair("SACR_SDTPS_LIF")[3]
    assert port.lif_temperature == 4.0 and isinstance(port.sacr, tsacr.SACR)


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def test_one_train_step_of_sacr_sdtps_lif_matches_jax(no_flax_dropout):
    """Loss (LIF_LOSS_WEIGHT on 'lif'), aux_loss['lif'], every gradient and
    the BatchNorm statistics (SACR's, LIF's, the heads')."""
    cfg = _cfg("SACR_SDTPS_LIF")
    case = jax_train_case(cfg, NUM_CLASSES, CAMERA_NUM)
    assert set(case["aux"]) == {"lif"} and case["aux"]["lif"] > 0
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), case["variables"])
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    grads = check_train_step(cfg, port, case, NUM_CLASSES)
    for k in ("sacr.core.atrous_2.conv.weight", "sacr.core.channel_attn.weight",
              "lif.tir_predictor.c0.conv.weight", "lif.rgb_predictor.head.bias"):
        assert np.abs(n(grads[k])).max() > 0, k
