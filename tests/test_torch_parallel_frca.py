"""DeMoParallel, the FRCA selector, DGAF V2 / V4 / V3Multi and SDTPSComplete
against the JAX package on the CPU: each module at a narrow width, FRCA at
C = 512 on the 16 x 8 patch grid (its 22 x 24 spectrum grid), then the
configs/ files through make_model at apply_tiny's widths (DeMo_Parallel.yml,
DeMo_FRCA_DGAF.yml and FRCA's other arms, MODEL.SDTPS_VARIANT 'complete' /
'fixed' on DeMo_SDTPS_DGAF.yml's keys), and whole f32 train steps of
DeMo_Parallel.yml with and without MODEL.PARALLEL_LOSS_PARITY against JAX's
build_train_step.  Every flax leaf is a seeded random value loaded into the
port through the converter.

Tolerance: rtol = atol = 1e-5 in f32, 1e-4 after FRCA's FFT (f32 FFTs of
two libraries, then an inverse FFT).  At the real bins of the spectrum (DC
and the even sizes' Nyquist rows and columns) the port sets the imaginary
part to its exact +0 (models/frca.py::channel_spectrum); XLA's FFT leaves
round-off of either sign there, which flips the phase of a negative real
bin between +pi and -pi.  The FRCA parity tests give the JAX module the same
exact bins (`exact_real_bins`, a patch of jnp.fft.fft2 in the test; nothing
of demo2_tpu/ changes), and a test of its own shows the flip.
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
from demo2_tpu.losses import losses as jl
from demo2_tpu.models import dgaf as jdgaf
from demo2_tpu.models import frca as jfrca
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.models import sdtps_variants as jvariants
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.models import dgaf as tdgaf
from demo2_tpu_torch.models import frca as tfrca
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.models.sdtps_variants import SDTPSComplete
from demo2_tpu_torch.utils.converters import convert_flax_variables
from torch_port_helpers import (CPU, apply_jit, assert_bf16_as_close_as_jax, check_train_step,
                                generator, jax_train_case, load_port, n, random_variables, t)

TOL = dict(rtol=1e-5, atol=1e-5)
FFT_TOL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES, CAMERA_NUM = 8, 4
GRID = (16, 8)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(autouse=True)
def exact_real_bins(monkeypatch):
    """jnp.fft.fft2 with the real bins' imaginary parts at their exact +0,
    as the port computes them."""
    fft2 = jnp.fft.fft2

    def exact(x, *args, **kwargs):
        s = fft2(x, *args, **kwargs)
        real = n(tfrca.real_bins(*s.shape[-2:], CPU))
        return jax.lax.complex(s.real, jnp.where(real, 0.0, s.imag))

    monkeypatch.setattr(jnp.fft, "fft2", exact)


# ---------------------------------------------------------------------------
# DGAF V2, V4, V3Multi
# ---------------------------------------------------------------------------

C, B, K = 64, 4, 10


def _dgaf_pair(name, jkw, tkw, *args, seed=1):
    jm = getattr(jdgaf, name)(feat_dim=C, **jkw)
    variables = random_variables(jm, *args, seed=seed)
    port = getattr(tdgaf, name)(C, dtype=torch.float32, device=CPU, generator=generator(),
                                **tkw)
    return jm, variables, load_port(port, variables)


def test_dgaf_v3multi_matches_jax():
    """Six token sets -> (B, 6C), V3's tree at six modalities."""
    tokens = _normal(6, B, K, C, seed=2)
    jm, variables, port = _dgaf_pair("DualGatedAdaptiveFusionV3Multi",
                                     dict(num_modalities=6, num_heads=8),
                                     dict(num_heads=8, tau=1.0, init_alpha=0.5), tokens)
    assert variables["params"]["pool"]["queries"].shape == (6, 1, C)
    assert port.pool.queries.shape == (6, 1, C) and port.core.gate_fc1.weight.shape == (6, C)
    got = port(t(tokens))
    assert got.shape == (B, 6 * C)
    np.testing.assert_allclose(n(got), np.asarray(apply_jit(jm, variables, tokens)), **TOL)


def test_dgaf_v4_matches_jax():
    h = _normal(3, B, C, seed=3)
    jm, variables, port = _dgaf_pair("DualGatedAdaptiveFusionV4", {},
                                     dict(tau=0.7, init_alpha=0.3), h)
    got = port(t(h))
    assert got.shape == (3, B, C)
    jm = jdgaf.DualGatedAdaptiveFusionV4(feat_dim=C, tau=0.7, init_alpha=0.3)
    np.testing.assert_allclose(n(got), np.asarray(apply_jit(jm, variables, h)), **TOL)


@pytest.mark.parametrize("with_tokens", [False, True], ids=["globals", "tokens"])
def test_dgaf_v2_matches_jax(with_tokens):
    h, tokens = _normal(3, B, C, seed=4), _normal(3, B, K, C, seed=5)
    jm, variables, port = _dgaf_pair("DualGatedAdaptiveFusionV2", dict(num_heads=4),
                                     dict(num_heads=4, tau=1.0, init_alpha=0.5), h, tokens)
    args = (h, tokens) if with_tokens else (h,)
    got = port(*(t(a) for a in args))
    assert got.shape == (3, B, C)
    np.testing.assert_allclose(n(got), np.asarray(apply_jit(jm, variables, *args)), **TOL)
    assert set(tdgaf.__dict__) >= {name for name in jdgaf.__dict__
                                   if name.startswith(("DualGated", "AttentionPool"))}


# ---------------------------------------------------------------------------
# FRCA
# ---------------------------------------------------------------------------

FRCA_C = 512  # a 22 x 24 spectrum grid with 16 padded cells


@functools.cache
def _frca_case(dtype, c=FRCA_C):
    jdt, _ = DTYPES[dtype]
    x = _normal(3, *GRID, c, seed=6)
    jm = jfrca.FourierResidualChannelAttention(channels=c, dtype=jdt)
    return x, jm, random_variables(jm, x, seed=7)


def _frca_port(variables, tdt, c=FRCA_C):
    return load_port(tfrca.FourierResidualChannelAttention(c, dtype=tdt, device=CPU,
                                                           generator=generator()), variables)


def test_frca_parts_match_jax():
    x = _normal(2, *GRID, 32, seed=8)
    for jm, port in (
        (jfrca.CLC(32, 3, 0.2), tfrca.CLC(32, 3, 0.2, dtype=torch.float32, device=CPU,
                                         generator=generator())),
        (jfrca.DNRU(32), tfrca.DNRU(32, dtype=torch.float32, device=CPU,
                                    generator=generator())),
    ):
        variables = random_variables(jm, x, seed=9)
        got = load_port(port, variables)(t(x))
        np.testing.assert_allclose(n(got), np.asarray(apply_jit(jm, variables, x)), **TOL)
    # DNRU's depthwise kernel: flax (3, 3, 1, C) -> the grouped (C, 1, 3, 3).
    sd = convert_flax_variables(variables, port)
    assert sd["dwconv.weight"].shape == (32, 1, 3, 3)
    np.testing.assert_array_equal(n(sd["dwconv.weight"]),
                                  variables["params"]["dwconv"]["kernel"].transpose(3, 2, 0, 1))
    assert tfrca._grid_dims(512) == jfrca._grid_dims(512) == (22, 24, 16)
    assert [tfrca.choose_gn_groups(c) for c in (512, 48, 20, 7)] == [32, 16, 4, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frca_matches_jax(dtype):
    x, jm, variables = _frca_case(dtype)
    tdt = DTYPES[dtype][1]
    port = _frca_port(variables, tdt)
    want = apply_jit(jm, variables, jnp.asarray(x, DTYPES[dtype][0]))
    got = port(t(x).to(tdt))
    assert got.shape == x.shape and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(n(got), np.asarray(want), **FFT_TOL)
    else:
        ref = apply_jit(_frca_case("float32")[1], variables, x)
        assert_bf16_as_close_as_jax(got, want, ref)


def test_frca_gradients_match_jax():
    """Through the FFT, the phase and amplitude stacks and the inverse FFT."""
    x, jm, variables = _frca_case("float32")
    port = _frca_port(variables, torch.float32)

    def j_loss(params, x):
        return jnp.sum(jnp.sin(jm.apply({"params": params}, x)))

    jg, jgx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(variables["params"], x)
    xt = t(x).requires_grad_(True)
    torch.sin(port(xt)).sum().backward()
    np.testing.assert_allclose(n(xt.grad), np.asarray(jgx), **FFT_TOL)
    want = convert_flax_variables({"params": jg}, port)
    for k, p in port.named_parameters():
        wk = n(want[k])
        np.testing.assert_allclose(n(p.grad), wk, rtol=1e-3, atol=1e-4 * np.abs(wk).max(),
                                   err_msg=k)
    assert np.abs(n(port.clc1_pha_conv1.weight.grad)).max() > 0


def test_frca_phase_at_the_real_bins(monkeypatch):
    """The port's spectrum is numpy's (f64) within f32 round-off, with the
    real bins exactly real: the phase there is 0 or pi by the sign of the
    real part.  numpy's own FFT and XLA's leave round-off of either sign
    there, and XLA's puts some negative real bins at -pi."""
    desc = _normal(64, FRCA_C, seed=10) - 0.5
    hc, wc, pad = tfrca._grid_dims(FRCA_C)
    spec = tfrca.channel_spectrum(t(desc)).numpy()
    ref = np.fft.fft2(np.pad(desc.astype(np.float64), ((0, 0), (0, pad))).reshape(-1, hc, wc))
    np.testing.assert_allclose(spec, ref, rtol=1e-5, atol=1e-4)
    real = n(tfrca.real_bins(hc, wc, CPU)).astype(bool)
    assert real.sum() == 4
    assert np.all(spec.imag[:, real] == 0) and not np.any(np.signbit(spec.imag[:, real]))
    np.testing.assert_array_equal(np.angle(spec)[:, real],
                                  np.where(ref.real[:, real] < 0, np.float32(np.pi), 0.0))
    assert np.any(ref.real[:, real] < 0) and np.any(ref.imag[:, real] != 0)
    # XLA's own FFT of the same grid: round-off of either sign at the real
    # bins, so some negative ones sit at -pi, 2 pi from the port's phase.
    monkeypatch.undo()
    grid = np.pad(desc, ((0, 0), (0, pad))).reshape(-1, hc, wc)
    raw = np.asarray(jnp.fft.fft2(grid))[:, real]
    flipped = np.abs(np.angle(raw) - np.angle(spec)[:, real]) > np.pi
    assert np.any(raw.imag != 0) and np.any(flipped)
    assert np.all(ref.real[:, real][flipped] < 0)


# ---------------------------------------------------------------------------
# SDTPSComplete
# ---------------------------------------------------------------------------

SC, SN = 64, 12


def _sdtps_case(use_cross_attn=True, use_gumbel=False, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    patches, globals_ = _normal(3, B, SN, SC, seed=11), _normal(3, B, SC, seed=12)
    kw = dict(num_heads=4, sparse_ratio=0.6, use_gumbel=use_gumbel, gumbel_tau=0.7,
              use_cross_attn=use_cross_attn)
    jm = jvariants.SDTPSComplete(embed_dim=SC, dtype=jdt, **kw)
    variables = random_variables(jm, patches, globals_, seed=13)
    port = SDTPSComplete(SC, dtype=tdt, device=CPU, generator=generator(), **kw)
    if use_cross_attn:
        port = load_port(port, variables)
    return jm, variables, port, patches, globals_


@pytest.mark.parametrize("use_gumbel", [False, True], ids=["hard", "gumbel"])
@pytest.mark.parametrize("use_cross_attn", [True, False], ids=["attention", "cosine"])
def test_sdtps_complete_matches_jax(use_cross_attn, use_gumbel):
    """At eval, and in training without Gumbel, the hard top-k mask."""
    jm, variables, port, patches, globals_ = _sdtps_case(use_cross_attn, use_gumbel)
    want_out, want_mask = apply_jit(jm, variables, patches, globals_)
    for train in (False, True) if not use_gumbel else (False,):
        out, mask = port(t(patches), t(globals_), train, generator(1))
        np.testing.assert_array_equal(n(mask), np.asarray(want_mask))
        np.testing.assert_allclose(n(out), np.asarray(want_out), **TOL)
    assert n(mask).sum(-1).tolist() == [[8.0] * B] * 3  # ceil(12 * 0.6) kept per row


def test_sdtps_complete_bf16_mask_is_jaxs():
    jm, variables, port, patches, globals_ = _sdtps_case(dtype="bfloat16")
    want_out, want_mask = apply_jit(jm, variables, jnp.asarray(patches, jnp.bfloat16),
                                    jnp.asarray(globals_, jnp.bfloat16))
    out, mask = port(t(patches).bfloat16(), t(globals_).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(mask), np.asarray(want_mask))
    np.testing.assert_array_equal(n(out), np.asarray(want_out, np.float32))


def test_sdtps_complete_gumbel_is_straight_through(monkeypatch):
    """In training with Gumbel the forward is the hard mask and the gradient
    the soft mask's; the noise draws from the generator passed in."""
    _, _, port, patches, globals_ = _sdtps_case(use_gumbel=True)
    p = t(patches).requires_grad_(True)
    out, mask = port(p, t(globals_), True, generator(5))
    hard = port(t(patches), t(globals_))[1]
    np.testing.assert_array_equal(n(mask), n(hard))
    np.testing.assert_array_equal(n(out), n(t(patches) * hard[..., None]))
    weights = t(_normal(3, B, SN, seed=14))
    (mask * weights).sum().backward(retain_graph=True)
    got = n(port.gate_scale.grad).copy()
    # The same draw through the soft mask alone (the last softmax of the
    # forward): its gradient is the STE's.
    port.zero_grad()
    softmax, last = torch.softmax, {}

    def spy(x, dim):
        last["soft"] = softmax(x, dim=dim)
        return last["soft"]

    monkeypatch.setattr(torch, "softmax", spy)
    port(t(patches), t(globals_), True, generator(5))
    monkeypatch.undo()
    (last["soft"] * weights).sum().backward()
    np.testing.assert_allclose(got, n(port.gate_scale.grad), rtol=1e-6, atol=1e-9)
    assert np.abs(got).max() > 0
    # Another seed draws other noise: the same forward, another gradient.
    port.zero_grad()
    (port(t(patches), t(globals_), True, generator(6))[1] * weights).sum().backward()
    assert not np.allclose(n(port.gate_scale.grad), got)


# ---------------------------------------------------------------------------
# The configs through make_model
# ---------------------------------------------------------------------------

CASES = {  # id: (YAML file under configs/RGBNT201/, MODEL overrides)
    "Parallel": ("DeMo_Parallel.yml", {}),
    "FRCA_DGAF": ("DeMo_FRCA_DGAF.yml", {}),
    "FRCA-branch2-global_local": ("DeMo_FRCA_DGAF.yml", {"USE_DGAF": False,
                                                          "GLOBAL_LOCAL": True, "DIRECT": 0}),
    "FRCA-v3-no_cross": ("DeMo_FRCA_DGAF.yml", {"FRCA_USE_CROSS_ATTN": False}),
    "FRCA-v1-global_local": ("DeMo_FRCA_DGAF.yml", {"DGAF_VERSION": "v1",
                                                     "GLOBAL_LOCAL": True}),
    "SDTPS_complete": ("DeMo_SDTPS_DGAF.yml", {"SDTPS_VARIANT": "complete"}),
    "SDTPS_fixed-branch2": ("DeMo_SDTPS_DGAF.yml", {"SDTPS_VARIANT": "fixed",
                                                    "USE_DGAF": False}),
    "Parallel-complete": ("DeMo_Parallel.yml", {"SDTPS_VARIANT": "complete"}),
}
PARALLEL_BRANCHES = [f"{fam}_{nm}" for fam in ("sdtps", "dgaf", "fused")
                     for nm in ("rgb", "nir", "tir")]
BRANCHES = {
    "Parallel": PARALLEL_BRANCHES,
    "FRCA_DGAF": ["dgaf"],
    "FRCA-branch2-global_local": ["frca", "ori_r", "ori_n", "ori_t"],
}
WIDTHS = {"Parallel": 9, "Parallel-complete": 9, "FRCA_DGAF": 6}  # x C; the rest 3


def _cfg(case, **model):
    path, overrides = CASES[case]
    cfg = get_cfg_defaults()
    cfg.merge_from_file(f"configs/RGBNT201/{path}")
    apply_tiny(cfg)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DATA_CACHE = "device"
    for k, v in {**overrides, **model}.items():
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

    return cfg, variables, port, jax.jit(apply), order


@pytest.mark.parametrize("case", list(CASES))
def test_configs_match_jax(case):
    cfg, variables, port, japply, order = _pair(case)
    h, w = cfg.INPUT.SIZE_TEST
    rng = np.random.default_rng(1)
    images = rng.standard_normal((3, 3, h, w, 3)).astype(np.float32)
    cams = rng.integers(0, CAMERA_NUM, 3).astype(np.int32)
    tol = FFT_TOL if "FRCA" in case else TOL
    for mask in (np.ones(3, np.float32), np.array([1.0, 0.0, 1.0], np.float32)):
        want = japply(variables, images, cams, mask)
        with torch.no_grad():
            got = port(t(images), t(cams).long(), None, t(mask))
        assert list(got["branches"]) == order[0] == BRANCHES.get(case, order[0])
        width = WIDTHS.get(case, 3) * 512
        assert got["embedding"].shape == (3, width) == want["embedding"].shape
        assert port.embed_dim == width
        np.testing.assert_allclose(n(got["embedding"]), np.asarray(want["embedding"]), **tol)
        for name, (logits, feat) in want["branches"].items():
            np.testing.assert_allclose(n(got["branches"][name][0]), np.asarray(logits),
                                       err_msg=name, **tol)
            np.testing.assert_allclose(n(got["branches"][name][1]), np.asarray(feat),
                                       err_msg=name, **tol)


def test_converter_fills_the_new_trees():
    """FRCA's three modules and the bridge, SDTPSComplete's gates and the
    nine heads: every leaf lands where it belongs, strictly both ways."""
    _, variables, port, _, _ = _pair("FRCA_DGAF")
    sd = convert_flax_variables(variables, port)
    p = variables["params"]
    assert {k.split(".")[0] for k in sd} == set(p)
    np.testing.assert_array_equal(n(sd["frca_nir.clc1_pha_conv1.weight"]),
                                  p["frca_nir"]["clc1_pha_conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(n(sd["frca_tir.dnru.gn.weight"]),
                                  p["frca_tir"]["dnru"]["gn"]["scale"])
    np.testing.assert_array_equal(n(sd["frca_cross_attn.in_proj_weight"]),
                                  p["frca_cross_attn"]["in_proj_kernel"].T)
    assert sd["dgaf.pool.queries"].shape == (6, 1, 512)
    _, variables, port, _, _ = _pair("SDTPS_complete")
    sd = convert_flax_variables(variables, port)
    np.testing.assert_array_equal(n(sd["sdtps.gate_bias"]),
                                  variables["params"]["sdtps"]["gate_bias"])
    _, variables, port, _, _ = _pair("Parallel")
    assert {k.split(".")[0] for k in convert_flax_variables(variables, port)} == set(
        variables["params"])
    flat = dict(flax.traverse_util.flatten_dict(variables))
    del flat[("params", "head_fused_tir", "classifier", "kernel")]
    with pytest.raises(ValueError, match="no leaf filled"):
        convert_flax_variables(flax.traverse_util.unflatten_dict(flat), port)


@pytest.mark.parametrize("parity", [False, True], ids=["families", "parity"])
def test_parallel_branch_weights_are_the_jax_packages(parity):
    cfg = _cfg("Parallel", PARALLEL_LOSS_PARITY=parity, SDTPS_LOSS_WEIGHT=2.0)
    got = tl.branch_weights(cfg, PARALLEL_BRANCHES)
    assert got == jl.branch_weights(cfg, PARALLEL_BRANCHES)
    assert list(got) == PARALLEL_BRANCHES
    if parity:
        assert got == {b: 2.0 if b == "sdtps_rgb" else 1.0 for b in PARALLEL_BRANCHES}
    else:
        assert got == {b: {"sdtps": 2.0, "dgaf": 1.0, "fused": 0.5}[b.split("_")[0]]
                       for b in PARALLEL_BRANCHES}


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


@pytest.mark.parametrize("parity", [False, True], ids=["families", "parity"])
def test_one_train_step_of_demo_parallel_matches_jax(parity, no_flax_dropout):
    """Loss with the branch weights of each rule, every gradient, the nine
    BNNecks' statistics."""
    cfg = _cfg("Parallel", PARALLEL_LOSS_PARITY=parity)
    case = jax_train_case(cfg, NUM_CLASSES, CAMERA_NUM)
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), case["variables"])
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    grads = check_train_step(cfg, port, case, NUM_CLASSES)
    for k in ("sdtps.q_proj_kernel", "dgaf.pool.queries", "gl_fuse.kernel",
              "head_fused_tir.classifier.weight"):
        assert np.abs(n(grads[k])).max() > 0, k


def test_one_train_step_of_frca_dgaf_matches_jax(no_flax_dropout):
    """The FRCA bridge in training: loss, every gradient through the FFTs."""
    cfg = _cfg("FRCA_DGAF")
    case = jax_train_case(cfg, NUM_CLASSES, CAMERA_NUM)
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), case["variables"])
    grads = check_train_step(cfg, port, case, NUM_CLASSES)
    assert np.abs(n(grads["frca_rgb.clc1_amp_conv0.weight"])).max() > 0


def _input_grad_turn(loss_of, x, noise):
    """The cosine between the input gradients of `loss_of` at x and at x
    times (1 + noise)."""
    a, b = (np.asarray(loss_of(x * s)).ravel() for s in (1.0, 1.0 + noise))
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_sdtps_input_gradient_is_ill_conditioned_in_both_packages():
    """Why chip_smoke.py holds DeMo_Parallel's backbone from one upstream
    gradient (ASSEMBLY_CASES): 0.4% of noise on SDTPS's input turns the
    gradient of the triplet losses of its token means by far more than it
    turns DGAF v3's, in the port and in the JAX package alike, at the same
    random weights (f32)."""
    from demo2_tpu.models.sdtps import MultiModalSDTPS as JSDTPS
    from demo2_tpu_torch.models.sdtps import MultiModalSDTPS

    b, tokens, c = 16, 128, 512
    patches, globals_ = _normal(3, b, tokens, c, seed=20), _normal(3, b, c, seed=21)
    noise = 4e-3 * _normal(3, b, tokens, c, seed=22)
    pids = np.arange(b) // 4
    jm = JSDTPS(embed_dim=c, sparse_ratio=0.6, use_cross_attn=True)
    variables = random_variables(jm, patches, globals_, seed=23)
    port = load_port(MultiModalSDTPS(c, sparse_ratio=0.6, use_cross_attn=True,
                                     dtype=torch.float32, device=CPU, generator=generator()),
                     variables)

    def port_grad(x):
        xt = t(x).requires_grad_(True)
        f = port(xt, t(globals_))[0].mean(2)
        loss = sum(tl.batch_hard_triplet_loss(f[i], t(pids)) for i in range(3))
        return n(torch.autograd.grad(loss, xt)[0])

    def j_loss(x):
        f = jnp.mean(jm.apply(variables, x, globals_)[0], axis=2)
        return sum(jl.batch_hard_triplet_loss(f[i], pids) for i in range(3))

    jax_grad = jax.jit(jax.grad(j_loss))
    dgaf = tdgaf.DualGatedAdaptiveFusionV3(c, tau=1.0, init_alpha=0.5, num_heads=8,
                                           dtype=torch.float32, device=CPU,
                                           generator=generator())

    def dgaf_grad(x):
        xt = t(x).requires_grad_(True)
        f = dgaf(xt).reshape(b, 3, c).transpose(0, 1)
        loss = sum(tl.batch_hard_triplet_loss(f[i], t(pids)) for i in range(3))
        return n(torch.autograd.grad(loss, xt)[0])

    turns = {name: _input_grad_turn(fn, patches, noise)
             for name, fn in (("port", port_grad), ("jax", jax_grad), ("dgaf", dgaf_grad))}
    assert turns["port"] < 0.95 and turns["jax"] < 0.95 and turns["dgaf"] > 0.99, turns
