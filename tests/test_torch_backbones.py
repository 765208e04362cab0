"""The port's other backbones against the JAX package on the CPU: T2T-ViT
(the sinusoid table, the unfold, the token transformer, the trunk), ResNet
with its IBN-a / IBN-b variants, OSNet with its AIN variant, resnet_tokens
and flax's BatchNorm.  Every flax leaf is a seeded random value loaded into
the port through the converter; inputs are seeded numpy arrays; images are
64x32.  The CNN trunks run at their full widths (they take no size
override) in training, where the updated BatchNorm statistics are held
against the batch_stats JAX returns; at eval they are held through PIFE
(tests/test_torch_backbones_pife.py, over every type).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.models import osnet as josnet, resnet as jresnet, t2t as jt2t
from demo2_tpu_torch.models import osnet, resnet, t2t
from demo2_tpu_torch.ops.norm import FlaxBatchNorm
from torch_port_helpers import (CPU, apply_jit, apply_train, as_close_as_jax, as_f64,
                                check_stats, generator, load_port, n, random_variables, t)

# f32 on both sides: only the summation order differs.
TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
F32 = torch.float32
CAMS, VIEWS = 3, 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread: the suite runs several workers, each
    with its own pool, and spinning pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(*shape, seed=0, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _kw():
    return dict(dtype=F32, device=CPU, generator=generator())


# ---------------------------------------------------------------------------
# T2T-ViT
# ---------------------------------------------------------------------------


def test_sinusoid_table_is_the_jax_packages():
    np.testing.assert_array_equal(t2t.sinusoid_encoding(129, 48),
                                  jt2t.sinusoid_encoding(129, 48))


@pytest.mark.parametrize("k,s,p,c", [(7, 4, 2, 3), (3, 2, 1, 8)])
def test_unfold_matches_jax(k, s, p, c):
    """torch's unfold and JAX's conv_general_dilated_patches order the
    features alike: C-major, kernel position minor."""
    x = _normal(2, c, 16, 12, seed=k)
    want, whw = jt2t._unfold(jnp.asarray(x), k, s, p)
    got, ghw = t2t.unfold(t(x), k, s, p)
    assert tuple(ghw) == tuple(whw)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_token_transformer_matches_jax():
    """The input width's softmax scale and the V-skip residual."""
    x = _normal(2, 40, 27, seed=1)
    jm = jt2t.TokenTransformer(16)
    variables = random_variables(jm, x, seed=1)
    port = load_port(t2t.TokenTransformer(27, 16, **_kw()), variables)
    want = apply_jit(jm, variables, jnp.asarray(x))
    np.testing.assert_allclose(n(port(t(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("camera,view", [(0, 0), (CAMS, VIEWS)], ids=["no-sie", "sie"])
def test_t2t_vit_matches_jax(camera, view):
    kw = dict(img_size=(64, 32), embed_dim=64, depth=2, num_heads=2, camera=camera, view=view)
    jm = jt2t.T2TViT(**kw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 32, 3)).astype(np.float32)
    cams, views = rng.integers(0, CAMS, 2), rng.integers(0, VIEWS, 2)
    variables = random_variables(jm, x, cams, views, seed=2)
    port = load_port(t2t.T2TViT(**kw, **_kw()), variables)
    want = apply_jit(jm, variables, *map(jnp.asarray, (x, cams, views)))
    got = port(t(x), t(cams).long(), t(views).long())
    assert got.shape == (2, 4 * 2 + 1, 64)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# The CNN trunks
# ---------------------------------------------------------------------------


def test_flax_batchnorm_matches_flax_in_eval_and_training():
    """flax's conventions: the fast variance, momentum 0.9 on the running
    statistics, the biased variance in them."""
    import flax.linen as fnn

    x = _normal(4, 5, 3, 6, seed=3, std=2.0) + 1.0
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = random_variables(jm, x, seed=3)
    port = load_port(FlaxBatchNorm(6, device=CPU), variables)
    want, stats = apply_train(jm, variables, jnp.asarray(x))
    np.testing.assert_allclose(n(port(t(x), train=True)), np.asarray(want), **TOL)
    check_stats(port, variables, stats, STATS_TOL)
    want_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": stats}, jnp.asarray(x))
    np.testing.assert_allclose(n(port(t(x))), np.asarray(want_eval), **TOL)


def _cnn_case(kind: str, name: str):
    """(jax module, variables, images, port module) of one CNN trunk."""
    if kind == "resnet":
        layers, ibn = jresnet.RESNET_CONFIGS[name]
        jm = jresnet.ResNet(layers=layers, ibn=ibn)
        make = lambda: resnet.ResNet(layers, ibn=ibn, **_kw())
    else:
        layers, chans = josnet.OSNET_CONFIGS[name]
        ain = name.startswith("osnet_ain")
        variants = josnet.OSNET_AIN_VARIANTS if ain else None
        jm = josnet.OSNet(layers=layers, channels=chans, block_variants=variants, conv1_in=ain)
        make = lambda: osnet.OSNet(layers, chans, block_variants=variants, conv1_in=ain, **_kw())
    x = _normal(2, 64, 32, 3, seed=4)
    variables = random_variables(jm, x, seed=4)
    return jm, variables, x, make


@pytest.mark.parametrize("kind,name", [("resnet", "resnet50"), ("resnet", "resnet50_ibn_a"),
                                       ("resnet", "resnet50_ibn_b"), ("osnet", "osnet_x1_0"),
                                       ("osnet", "osnet_ain_x1_0")])
def test_cnn_trunk_in_training_matches_jax(kind, name):
    """The feature map in training, with the BatchNorms' batch statistics,
    whose running statistics must then equal JAX's batch_stats.  (At eval
    each trunk is held through PIFE below.)"""
    jm, variables, x, make = _cnn_case(kind, name)
    port = load_port(make(), variables)
    want, stats = apply_train(jm, variables, jnp.asarray(x), train=True)
    with torch.no_grad():
        got = port(t(x), True)
    assert got.shape == want.shape == (2, 4, 2, 2048 if kind == "resnet" else 512)
    check_stats(port, variables, stats, STATS_TOL)
    with torch.no_grad():
        ref = n(as_f64(load_port(make(), variables))(t(x).double(), True))
    as_close_as_jax(got, want, ref)


def test_cnn_blocks_of_each_variant():
    """IBN-a splits cb1's norm in layers 1-3 and not in layer 4; IBN-b has
    the IN stem and an IN after the add in the last block of layers 1-2;
    osnet_ain's blocks follow OSNET_AIN_VARIANTS, conv3 without BN where
    "ain"; one ChannelGate a block."""
    ibn_a = resnet.ResNet((3, 4, 6, 3), ibn="a", **_kw())
    assert ibn_a.layer3_5.cb1.norm == "ibn" and ibn_a.layer4_0.cb1.norm == "bn"
    ibn_b = resnet.ResNet((3, 4, 6, 3), ibn="b", **_kw())
    assert ibn_b.stem.norm == "in"
    assert [ibn_b.layer1_2.in_out is not None, ibn_b.layer1_1.in_out is None,
            ibn_b.layer2_3.in_out is not None, ibn_b.layer3_5.in_out is None] == [True] * 4
    ain = osnet.OSNet((2, 2, 2), (16, 64, 96, 128), block_variants=osnet.OSNET_AIN_VARIANTS,
                      conv1_in=True, **_kw())
    assert ain.conv1.use_in
    got = [[getattr(ain, f"conv{s + 2}_{j}").ain for j in range(2)] for s in range(3)]
    assert got == [[v == "ain" for v in row] for row in josnet.OSNET_AIN_VARIANTS]
    assert len([m for m in ain.conv2_0.modules() if isinstance(m, osnet.ChannelGate)]) == 1


def test_resnet_tokens_match_jax():
    fmap = _normal(2, 4, 2, 8, seed=5)
    for got, want in zip(resnet.resnet_tokens(t(fmap)), jresnet.resnet_tokens(jnp.asarray(fmap))):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-6)
