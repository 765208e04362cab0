"""The port's serving slice against the JAX package, end to end on the CPU.

The tiny flagship DeMo (apply_flagship off-TPU + apply_tiny, f32, with
USE_FLASH_ATTENTION on so that JAX takes the fused blocks' off-TPU paths)
gets every flax leaf set to a seeded random value; the port loads the same
values through the converter.  Embeddings and logits must agree to f32
summation-order noise.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.serving import FeatureExtractor as JFeatureExtractor
from demo2_tpu.serving import match as j_match
from demo2_tpu.utils.metrics import R1mAPEvaluator as JEvaluator
from demo2_tpu.utils.metrics import cmc_map_device
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.serving import FeatureExtractor, match
from demo2_tpu_torch.utils.converters import convert_flax_variables
from demo2_tpu_torch.utils.metrics import R1mAPEvaluator, cmc_map
from torch_port_helpers import CPU, generator, load_port, n, random_variables, t

NUM_CLASSES, CAMERA_NUM = 6, 4
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(cross_attn_type="attention", direct=1):
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.TPU.USE_FLASH_ATTENTION = True
    cfg.MODEL.SDTPS_CROSS_ATTN_TYPE = cross_attn_type
    cfg.MODEL.SDTPS_SPARSE_RATIO = 0.7
    cfg.MODEL.DIRECT = direct
    return cfg.freeze()


class _Pair:
    """One config's JAX model + random variables and the port model."""

    def __init__(self, cfg):
        self.cfg = cfg
        h, w = cfg.INPUT.SIZE_TEST
        self.jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
        self.variables = random_variables(self.jmodel, np.zeros((2, 3, h, w, 3), np.float32),
                                          np.zeros((2,), np.int32), train=False)
        self.port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                         generator=generator()), self.variables)
        self.japply = jax.jit(lambda v, x, c, m: self.jmodel.apply(v, x, c, None, m, train=False))


@functools.cache
def _pair(cross_attn_type, direct):
    return _Pair(_cfg(cross_attn_type, direct))


def _images(n_img, cfg, seed):
    h, w = cfg.INPUT.SIZE_TEST
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_img, 3, h, w, 3)).astype(np.float32),
            rng.integers(0, CAMERA_NUM, n_img).astype(np.int32))


@pytest.mark.parametrize("miss", [(1.0, 1.0, 1.0), (1.0, 0.0, 0.0)], ids=["None", "nt"])
@pytest.mark.parametrize("cross_attn_type,direct",
                         [("attention", 1), ("cosine", 1), ("attention", 0)])
def test_demo_slice_matches_jax(cross_attn_type, direct, miss):
    pair = _pair(cross_attn_type, direct)
    images, cams = _images(3, pair.cfg, seed=1)
    mask = np.asarray(miss, np.float32)
    want = pair.japply(pair.variables, images, cams, mask)
    with torch.no_grad():
        got = pair.port(t(images), t(cams).long(), None, t(mask))
    assert set(got["branches"]) == set(want["branches"])
    assert got["embedding"].dtype == torch.float32 and got["embedding"].shape == (3, 1536)
    np.testing.assert_allclose(n(got["embedding"]), np.asarray(want["embedding"]), **TOL)
    for name, (logits, feat) in want["branches"].items():
        np.testing.assert_allclose(n(got["branches"][name][0]), np.asarray(logits), **TOL)
        np.testing.assert_allclose(n(got["branches"][name][1]), np.asarray(feat), **TOL)


def test_converter_fills_every_tensor_from_every_leaf():
    pair = _pair("attention", 1)
    flat = flax.traverse_util.flatten_dict(pair.variables)
    # No leaf is left at a zero or constant init that could hide a layout bug.
    assert all(np.ptp(v) > 0 or v.size == 1 for v in flat.values())
    sd = convert_flax_variables(pair.variables, pair.port)
    assert set(sd) == set(pair.port.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(v.size for v in flat.values())
    p = pair.variables["params"]
    blk = p["backbone"]["base"]["resblocks_1"]
    np.testing.assert_array_equal(n(sd["backbone.base.resblocks.1.attn.in_proj_weight"]),
                                  blk["attn"]["in_proj_kernel"].T)
    np.testing.assert_array_equal(n(sd["backbone.base.conv1.weight"]),
                                  p["backbone"]["base"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(n(sd["dgaf.core.entropy_proj.weight"]),
                                  p["dgaf"]["core"]["entropy_proj"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(n(sd["sdtps.modal_weight_mlp.2.fc2.weight"]),
                                  p["sdtps"]["modal_weight_mlp_2"]["fc2"]["kernel"].T)
    np.testing.assert_array_equal(
        n(sd["head_dgaf.bottleneck.bn.running_var"]),
        pair.variables["batch_stats"]["head_dgaf"]["bottleneck"]["bn"]["var"])


@pytest.mark.parametrize("fault", ["leaf_left_over", "tensor_left_unfilled", "wrong_shape"])
def test_converter_is_strict_both_ways(fault):
    pair = _pair("attention", 1)
    flat = dict(flax.traverse_util.flatten_dict(pair.variables))
    key = ("params", "dgaf", "core", "gate_ln", "scale")
    if fault == "leaf_left_over":
        flat[("params", "dgaf", "core", "extra", "kernel")] = np.ones((2, 2), np.float32)
    elif fault == "tensor_left_unfilled":
        del flat[key]
    else:
        flat[key] = np.ones((7,), np.float32)
    with pytest.raises(ValueError):
        convert_flax_variables(flax.traverse_util.unflatten_dict(flat), pair.port)


def test_feature_extractor_matches_jax():
    pair = _pair("attention", 1)
    jfx = JFeatureExtractor(pair.cfg, pair.jmodel, jax.tree.map(jnp.asarray, pair.variables),
                            batch_size=4)
    fx = FeatureExtractor(pair.cfg, pair.port, device=CPU, batch_size=4)
    images, cams = _images(5, pair.cfg, seed=2)
    for n_req in (0, 1, 5):
        for miss in ("None", "nt"):
            got = fx.extract(images[:n_req], cams[:n_req], miss=miss)
            want = jfx.extract(images[:n_req], cams[:n_req], miss=miss)
            assert got.shape == want.shape == (n_req, 1536) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    emb = fx.extract(images, cams)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    # A ragged chunk is padded by repeating its last row, which is dropped.
    np.testing.assert_allclose(fx.extract(images[4:], cams[4:]), emb[4:], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        fx.extract(images, cams, miss="rnt")


def test_feature_extractor_raw_embeddings_match_jax():
    """normalize=False: the embeddings as the model gives them, equal to the
    JAX extractor's with normalize=False from the same weights, and not of
    unit norm; the default still normalises them."""
    pair = _pair("attention", 1)
    jfx = JFeatureExtractor(pair.cfg, pair.jmodel, jax.tree.map(jnp.asarray, pair.variables),
                            batch_size=4, normalize=False)
    fx = FeatureExtractor(pair.cfg, pair.port, device=CPU, batch_size=4, normalize=False)
    images, cams = _images(5, pair.cfg, seed=2)
    for miss in ("None", "nt"):
        got = fx.extract(images, cams, miss=miss)
        want = jfx.extract(images, cams, miss=miss)
        assert got.shape == want.shape == (5, 1536) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    raw = fx.extract(images, cams)
    norms = np.linalg.norm(raw, axis=1)
    assert np.abs(norms - 1.0).min() > 1e-3
    unit = FeatureExtractor(pair.cfg, pair.port, device=CPU, batch_size=4).extract(images, cams)
    np.testing.assert_allclose(unit, raw / norms[:, None], rtol=1e-5, atol=1e-6)
    assert fx.extract(images[:0], cams[:0]).shape == (0, 1536)


def test_match_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    g = np.concatenate([q + 0.01, rng.standard_normal((9, 16)).astype(np.float32)])
    idx, dist = match(q, g, topk=5, device=CPU)
    jidx, jdist = j_match(q, g, topk=5)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(dist, jdist, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(idx[:, 0], np.arange(4))


def _protocol(seed):
    rng = np.random.default_rng(seed)
    nq, ng = 12, 40
    q_pids, g_pids = rng.integers(0, 6, nq), rng.integers(0, 6, ng)
    q_cams, g_cams = rng.integers(0, 3, nq), rng.integers(0, 3, ng)
    distmat = rng.standard_normal((nq, ng)).astype(np.float32)
    return distmat, q_pids, g_pids, q_cams, g_cams


def test_cmc_map_matches_cmc_map_device():
    args = _protocol(4)
    cmc, m_ap = cmc_map(*(t(a) for a in args), max_rank=10)
    jcmc, jmap = cmc_map_device(*(jnp.asarray(a) for a in args), max_rank=10)
    np.testing.assert_allclose(n(cmc), np.asarray(jcmc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(m_ap), float(jmap), rtol=1e-6, atol=1e-6)


def test_r1map_evaluator_matches_jax():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((30, 8)).astype(np.float32)
    pids, cams = rng.integers(0, 5, 30), rng.integers(0, 3, 30)
    ev, jev = R1mAPEvaluator(num_query=10, device=CPU), JEvaluator(num_query=10)
    for e in (ev, jev):
        e.update(feats[:17], pids[:17], cams[:17])
        e.update(feats[17:], pids[17:], cams[17:])
    (cmc, m_ap), (jcmc, jmap) = ev.compute(), jev.compute()
    np.testing.assert_allclose(cmc, jcmc, rtol=1e-6, atol=1e-6)
    assert abs(m_ap - jmap) < 1e-6
