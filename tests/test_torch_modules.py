"""Each module of the port against its flax original, on the CPU.

Every flax leaf is a seeded random value, loaded into the port through the
converter; inputs are seeded numpy arrays given to both.  f32 unless a test
says otherwise; the tolerances allow for summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.models.clip_vit import CLIPVisionTransformer as JViT
from demo2_tpu.models.dgaf import DualGatedAdaptiveFusionV3 as JDGAF
from demo2_tpu.models.heads import ClassifierHead as JHead
from demo2_tpu.models.pife import PIFE as JPIFE
from demo2_tpu.models.sdtps import MultiModalSDTPS as JSDTPS
from demo2_tpu.ops.activations import quick_gelu as j_quick_gelu
from demo2_tpu.ops.attention import MultiHeadAttention as JMHA
from demo2_tpu.ops.norm import LayerNorm as JLayerNorm
from demo2_tpu_torch.models.clip_vit import CLIPVisionTransformer
from demo2_tpu_torch.models.dgaf import DualGatedAdaptiveFusionV3
from demo2_tpu_torch.models.heads import ClassifierHead
from demo2_tpu_torch.models.pife import PIFE
from demo2_tpu_torch.models.sdtps import MultiModalSDTPS
from demo2_tpu_torch.ops.activations import quick_gelu
from demo2_tpu_torch.ops.attention import MultiHeadAttention
from demo2_tpu_torch.ops.norm import LayerNorm
from torch_port_helpers import CPU, apply_jit, generator, load_port, n, random_variables, t

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(*shape, seed=0, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def test_quick_gelu():
    x = _normal(5, 7, seed=1) * 4
    np.testing.assert_allclose(n(quick_gelu(t(x))), np.asarray(j_quick_gelu(x)), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    x = _normal(4, 9, 32, seed=2) * 3 + 1.5  # |mean| well away from 0
    jm = JLayerNorm()
    var = random_variables(jm, x)
    port = load_port(LayerNorm(32, device=CPU), var)
    want = apply_jit(jm, var, jnp.asarray(x, dtype))
    got = port(t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: mean/variance in f32, the normalising arithmetic in bf16.  Under
    # jit XLA fuses that chain and may skip the bf16 rounding of x - mean,
    # which the port (op by op, as the unjitted JAX graph) keeps: at |x| ~ 10
    # that moves an output by up to a few bf16 ulps, so allow 4.
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -6, atol=2 ** -5)
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross_query_len_1"])
def test_multi_head_attention(cross):
    q = _normal(6, 1 if cross else 7, 32, seed=3)
    kv = _normal(6, 9, 32, seed=4) if cross else None
    jm = JMHA(num_heads=4, dtype=jnp.float32)
    args = (q,) if kv is None else (q, kv)
    var = random_variables(jm, *args)
    port = load_port(MultiHeadAttention(32, 4, dtype=F32, device=CPU, generator=generator()), var)
    want = apply_jit(jm, var, *args)
    got = port(t(q), None if kv is None else t(kv))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_blocks", "plain_blocks"])
def test_clip_vision_transformer(fused):
    x = _normal(2, 64, 32, 3, seed=5)
    cv = _normal(2, 64, seed=6, std=0.5)
    jm = JViT(h_resolution=4, w_resolution=2, width=64, layers=2, heads=2,
              attn_implementation="pallas" if fused else "xla")
    var = random_variables(jm, x, cv)
    port = load_port(CLIPVisionTransformer(4, 2, stride_size=16, width=64, layers=2, heads=2,
                                           dtype=F32, fused=fused, device=CPU,
                                           generator=generator()), var)
    want = apply_jit(jm, var, x, cv)
    got = port(t(x), t(cv))
    assert got.shape == (2, 9, 512)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mask", [(1.0, 0.0, 1.0), ((1.0, 1.0, 0.0), (0.0, 1.0, 1.0))],
                         ids=["mask_3", "mask_B3"])
def test_pife_clip_branch(mask):
    images = _normal(2, 3, 64, 32, 3, seed=7)
    cams = np.array([1, 3], np.int32)
    mask = np.asarray(mask, np.float32)
    kw = dict(transformer_type="ViT-B-16", img_size=(64, 32), stride_size=(16, 16),
              camera_num=4, sie_coe=3.0)
    jm = JPIFE(**kw, width_override=64, depth_override=2, heads_override=2,
               attn_implementation="pallas")
    var = random_variables(jm, images, cams, None, mask)
    port = load_port(PIFE(**kw, sie_camera=True, dtype=F32, fused=True, depth_override=2,
                          width_override=64, heads_override=2, device=CPU,
                          generator=generator()), var)
    want_p, want_g = apply_jit(jm, var, images, cams, None, mask)
    got_p, got_g = port(t(images), t(cams).long(), None, t(mask))
    assert got_p.shape == (3, 2, 8, 512) and got_g.shape == (3, 2, 512)
    np.testing.assert_allclose(n(got_p), np.asarray(want_p), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(got_g), np.asarray(want_g), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cross_attn_type", ["attention", "cosine"])
def test_sdtps(cross_attn_type):
    patches = _normal(3, 2, 10, 32, seed=8)
    globals_ = _normal(3, 2, 32, seed=9)
    use_cross = cross_attn_type == "attention"
    jm = JSDTPS(embed_dim=32, sparse_ratio=0.7, use_cross_attn=use_cross)
    var = random_variables(jm, patches, globals_)
    port = load_port(MultiModalSDTPS(32, sparse_ratio=0.7, use_cross_attn=use_cross, dtype=F32,
                                     device=CPU, generator=generator()), var)
    want_e, want_m = apply_jit(jm, var, patches, globals_)
    got_e, got_m = port(t(patches), t(globals_))
    np.testing.assert_allclose(n(got_m), np.asarray(want_m), **TOL)
    np.testing.assert_allclose(n(got_e), np.asarray(want_e), **TOL)


def test_dgaf_v3():
    tokens = _normal(3, 2, 10, 32, seed=10)
    jm = JDGAF(feat_dim=32, num_heads=4)
    var = random_variables(jm, tokens)
    port = load_port(DualGatedAdaptiveFusionV3(32, tau=1.0, init_alpha=0.5, num_heads=4,
                                               dtype=F32, device=CPU, generator=generator()),
                     var)
    want = apply_jit(jm, var, tokens)
    got = port(t(tokens))
    assert got.shape == (2, 96)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_bnneck_classifier_head_eval():
    feat = _normal(4, 24, seed=11) * 2 + 0.5
    jm = JHead(num_classes=5)
    var = random_variables(jm, feat, use_running_average=True)
    port = load_port(ClassifierHead(24, 5, device=CPU, generator=generator()), var)
    want = apply_jit(jm, var, feat, use_running_average=True)  # running statistics
    got = port(t(feat))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    bn = var["batch_stats"]["bottleneck"]["bn"]
    scale = var["params"]["bottleneck"]["bn"]["scale"]
    want_bn = (feat - bn["mean"]) / np.sqrt(bn["var"] + 1e-5) * scale  # bias-free
    np.testing.assert_allclose(n(port.bottleneck(t(feat))), want_bn, rtol=1e-5, atol=1e-5)
