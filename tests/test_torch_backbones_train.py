"""DeMo's flagship fusion (SDTPS + DGAF v3) on the other backbones, T2T-ViT,
ResNet-IBN-a and OSNet-AIN, through make_model: one whole f32 train step
against JAX's (loss, every gradient, the BatchNorm statistics the CNN
trunk's and the heads' forward updated), on the CPU at 64x32, T2T at two
blocks of 64.

JAX's DeMo builds SDTPS and DGAF at feat_dim_for's 768 whatever the backbone
gives, and its forward then fails to broadcast the 384 / 512 / 2,048 / 256
wide tokens of these backbones; the port builds them at the backbone's width
(D6 in ROADMAP.md).  A fixture gives JAX's DeMo the backbone's width through
its module's `feat_dim_for`, so both build the same modules.  Nothing of
demo2_tpu/ changes.

T2T is held as the ImageNet ViT's train step is (check_train_step).  The CNN
trunks normalise by batch statistics in training, which magnify f32
summation noise, and JAX's f32 step is the noisier: on osnet_ain_x0_5 its
loss lies 9.2e-5 (relative) from an f64 run of the port, the port's f32
loss 1.6e-6; its whole gradient has a cosine of 0.99949 to the f64 one, the
port's 0.99997.  So there both are held against the port's f64 step: the
port's f32 loss, gradient and BatchNorm statistics about as far from it as
JAX's (at most twice as far, plus a floor of f32 noise: both are noise),
and JAX's within LOSS_REL / GRAD_COS of it (the same function).
That comparison needs a loss without discrete picks: batch-hard triplet
mining and its margin's relu switch where two distances nearly tie, and
such a switch between the f32 and the f64 run turns a whole gradient (a
cosine of 0.945 at 4 ids x 2).  The CNN steps take
DATALOADER.SAMPLER 'softmax' (cross-entropy alone), the T2T step the
flagship's loss with the triplet.
"""

import flax.linen
import jax
import numpy as np
import pytest
import torch

import demo2_tpu.models.demo as jdemo
from demo2_tpu.losses import losses as jl
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu_torch.config import get_cfg_defaults
from demo2_tpu_torch.config.presets import apply_flagship, apply_tiny
from demo2_tpu_torch.engine.train import loss_and_grads
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.utils.converters import convert_flax_variables
from torch_port_helpers import (CPU, check_train_step, generator, jax_train_case, load_port, n,
                                random_variables, t)

NUM_CLASSES, CAMERA_NUM = 8, 3
LOSS_REL = 2e-4
GRAD_COS = 0.999
# TRANSFORMER_TYPE -> the width its backbone gives at apply_tiny's sizes
# (T2T takes TPU.BACKBONE_WIDTH 64; the CNN trunks take no override).
WIDTHS = {"t2t_vit_t_24": 64, "resnet50_ibn_a": 2048, "osnet_ain_x0_5": 256}


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread: the suite runs several workers, each
    with its own pool, and spinning pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(tt):
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.MODEL.TRANSFORMER_TYPE = tt
    cfg.MODEL.SDTPS_CROSS_ATTN_TYPE = "attention"
    cfg.MODEL.DROP_PATH = 0.0  # its draws are JAX's own (test_torch_vit.py holds drop path)
    return cfg


def test_jax_demo_cannot_run_these_backbones_at_feat_dim_for():
    """Why the port differs (D6): JAX's DeMo fails on the 128-wide OSNet
    tokens with its 768-wide modules; the port builds them 128 wide."""
    cfg = _cfg("osnet_x0_25")
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    with pytest.raises(ValueError, match="broadcast"):
        jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                           np.zeros((2, 3, 64, 32, 3), np.float32),
                                           np.zeros((2,), np.int32)))
    port = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    assert port.feat_dim == 128 and port.sdtps.q_proj_kernel.shape[-1] == 128


def _port(cfg, variables, dtype=torch.float32):
    """The port's model from JAX's variables, modal-weight dropout off, in
    `dtype` (parameters, buffers and compute)."""
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), variables)
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    if dtype == torch.float64:
        port = port.double()
        for m in port.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float64
    return port


def _cosine(a: dict, b: dict) -> float:
    x = np.concatenate([n(a[k]).ravel() for k in sorted(a)]).astype(np.float64)
    y = np.concatenate([n(b[k]).ravel() for k in sorted(a)]).astype(np.float64)
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


def test_one_train_step_on_t2t_matches_jax(monkeypatch, no_flax_dropout):
    """Loss, every gradient (the trunk's included), the heads' BatchNorm
    statistics and the post-step state, as test_torch_vit.py holds DeMo on
    the ImageNet ViT."""
    tt = "t2t_vit_t_24"
    monkeypatch.setattr(jdemo, "feat_dim_for", lambda _: WIDTHS[tt])
    cfg = _cfg(tt)
    case = jax_train_case(cfg, NUM_CLASSES, CAMERA_NUM)
    port = _port(cfg, case["variables"])
    assert port.feat_dim == WIDTHS[tt]
    grads = check_train_step(cfg, port, case, NUM_CLASSES)
    assert np.abs(n(grads["backbone.base.tokens_to_token.attention1.qkv.weight"])).max() > 0
    assert np.abs(n(grads["backbone.base.blocks.1.attn.qkv.weight"])).max() > 0
    with torch.no_grad():
        emb = port(t(case["images"][:4]), t(case["cams"][:4]).long())["embedding"]
    assert emb.shape == (4, 3 * WIDTHS[tt])


@pytest.mark.parametrize("tt", ["resnet50_ibn_a", "osnet_ain_x0_5"])
def test_one_train_step_on_a_cnn_trunk_matches_jax(tt, monkeypatch, no_flax_dropout):
    """The loss (cross-entropy over the flagship fusion's branches), the
    whole gradient and every BatchNorm's statistics of one f32 train step,
    each against the port's f64 step: the port's no further from it than
    JAX's (see the module docstring)."""
    monkeypatch.setattr(jdemo, "feat_dim_for", lambda _: WIDTHS[tt])
    cfg = _cfg(tt)
    cfg.DATALOADER.SAMPLER = "softmax"  # no discrete picks (module docstring)
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(8)
    images = rng.standard_normal((16, 3, h, w, 3)).astype(np.float32)  # 8 ids x 2
    pids = np.repeat(np.arange(8), 2).astype(np.int32)
    cams = rng.integers(0, CAMERA_NUM, 16).astype(np.int32)
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, images[:2], cams[:2], train=False, seed=8)
    loss_fn = jl.make_loss_fn(cfg, NUM_CLASSES)

    def j_loss(params):
        out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                images, cams, cams * 0, None, train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        wts = jl.branch_weights(cfg, out["branches"].keys())
        return sum(wts[k] * loss_fn(lg, f, pids) for k, (lg, f) in out["branches"].items()), \
            upd["batch_stats"]

    (j_loss_value, j_stats), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    runs = {}
    for dtype in (torch.float32, torch.float64):
        port = _port(cfg, variables, dtype)
        loss, _, grads = loss_and_grads(cfg, port, tl.make_loss_fn(cfg, NUM_CLASSES),
                                        t(images).to(dtype), t(pids).long(), t(cams).long(), None)
        runs[dtype] = (float(loss), grads, port.state_dict())
    (loss32, grads32, sd32), (loss64, grads64, sd64) = runs[torch.float32], runs[torch.float64]
    assert port.feat_dim == WIDTHS[tt]
    j_loss_value = float(j_loss_value)
    assert abs(j_loss_value - loss64) <= LOSS_REL * abs(loss64)
    assert abs(loss32 - loss64) <= 2 * abs(j_loss_value - loss64) + 1e-5 * abs(loss64)
    want = convert_flax_variables({"params": j_grads, "batch_stats": j_stats}, port)
    jg = {k: want[k] for k in grads32}
    assert set(grads32) == {k for k, _ in port.named_parameters()}
    cos_jax, cos_port = _cosine(jg, grads64), _cosine(grads32, grads64)
    print(f"{tt}: gradient cosine to the f64 step, JAX {cos_jax:.6f}, port {cos_port:.6f}; "
          f"loss {j_loss_value - loss64:.3e} / {loss32 - loss64:.3e} from it")
    assert cos_jax >= GRAD_COS
    assert 1 - cos_port <= 2 * (1 - cos_jax) + 1e-5
    trunk = [k for k in grads32 if k.startswith("backbone.base.")]
    assert _cosine({k: grads32[k] for k in trunk}, {k: grads64[k] for k in trunk}) >= GRAD_COS
    before = convert_flax_variables(variables, port)
    stats = [k for k in sd32 if k.endswith(("running_mean", "running_var"))]
    assert any(k.startswith("backbone.base.") for k in stats)
    for k in stats:
        got, ref, jax_k = n(sd32[k]), n(sd64[k]), n(want[k])
        assert not np.array_equal(got, n(before[k])), k
        assert np.abs(got - ref).max() <= 2 * np.abs(jax_k - ref).max() + 1e-6, k
