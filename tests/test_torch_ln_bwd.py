"""The port's one-pass LayerNorm backward (TPU.PALLAS_LN_BWD) against the JAX
package on the CPU.

On the CPU the wrapper of kernel 11 takes its plain PyTorch version; that is
held here against the Pallas kernel it replaces, run in interpret mode as
tests/test_pallas_kernels.py runs it.  LayerNormFn is held against autograd
of the default route and against jax.grad of layernorm_pallas_bwd, and one
whole f32 train step of the tiny flagship with the flag on against JAX's
build_train_step with the same flag, with the fused attention on and off.
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
from demo2_tpu.engine import create_train_state as j_create_train_state
from demo2_tpu.engine.train import build_train_step as j_build_train_step
from demo2_tpu.losses import losses as jl
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.ops.norm import _layernorm_fwd_expr, _ln_bwd_call, layernorm_pallas_bwd
from demo2_tpu_torch.data import device_cache as dc
from demo2_tpu_torch.data.datasets import SyntheticTriModal
from demo2_tpu_torch.data.sampler import RandomIdentitySampler
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.engine.train import build_train_step, loss_and_grads
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.ops import norm as tnorm
from demo2_tpu_torch.utils.converters import convert_flax_variables
from torch_port_helpers import CPU, generator, load_port, n, random_variables, t

EPS = 1e-5


def _ln_inputs(r, c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, c)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((r, c)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, dy, w, b


# ---------------------------------------------------------------------------
# Kernel 11's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


# R = 300 leaves a 44-row tail in the TPU kernel's 256-row blocks (it pads
# with zero rows; the port pads nothing); R = 512 is two whole blocks.
@pytest.mark.parametrize("rows", [300, 512])
def test_plain_backward_matches_pallas_kernel_f32(rows):
    x, dy, w, _ = _ln_inputs(rows, 64, seed=rows)
    want = _ln_bwd_call(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(w), EPS, True)
    got = tnorm.layernorm_bwd(t(x), t(dy), t(w), EPS)
    assert [g.dtype for g in got] == [torch.float32] * 3
    assert got[0].shape == (rows, 64) and got[1].shape == got[2].shape == (64,)
    # f32 on both sides; only the order of the column sums differs.
    for name, g, wnt in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(n(g), np.asarray(wnt), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rows", [300, 512])
def test_plain_backward_matches_pallas_kernel_bf16(rows):
    x, dy, w, _ = _ln_inputs(rows, 64, seed=rows + 1)
    xb, dyb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    want = _ln_bwd_call(xb, dyb, jnp.asarray(w), EPS, True)
    got = tnorm.layernorm_bwd(t(x).to(torch.bfloat16), t(dy).to(torch.bfloat16), t(w), EPS)
    assert got[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    # dx is rounded to bf16 on both sides: one bf16 ulp at |dx| < 4 is 2^-6.
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0], np.float32), rtol=0, atol=2e-2)
    # The sums are f32 sums of the same bf16 inputs.
    for name, g, wnt in zip(("dscale", "dbias"), got[1:], want[1:]):
        np.testing.assert_allclose(n(g), np.asarray(wnt), rtol=1e-3, atol=1e-4, err_msg=name)


def test_plain_backward_is_the_gradient_of_the_f64_layernorm():
    x, dy, w, b = _ln_inputs(37, 48, seed=5)
    xd = t(x).double().requires_grad_(True)
    wd, bd = t(w).double().requires_grad_(True), t(b).double().requires_grad_(True)
    torch.nn.functional.layer_norm(xd, (48,), wd, bd, EPS).backward(t(dy).double())
    got = tnorm.layernorm_bwd_plain(t(x), t(dy), t(w), EPS)
    for g, want in zip(got, (xd.grad, wd.grad, bd.grad)):
        np.testing.assert_allclose(n(g), n(want), rtol=1e-4, atol=1e-5)


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    x = torch.zeros(4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tnorm.layernorm_bwd(x, x, torch.zeros(64, device="meta"), EPS)


@pytest.mark.parametrize("cols,dtype,item", [
    (768, torch.bfloat16, None),
    (1024, torch.float32, None),
    (1032, torch.bfloat16, "Kernel 11 beyond 1,024 columns"),
    (770, torch.bfloat16, "Kernel 11 beyond 1,024 columns"),
    (766, torch.float32, "Kernel 11 beyond 1,024 columns"),
    (768, torch.float16, "f32 inputs in the attention kernels"),
])
def test_kernel_limits_name_their_roadmap_item(cols, dtype, item):
    """The widths and dtypes the kernel refuses raise naming their ROADMAP
    item: a width over 1,024 columns (or not a whole 16-byte vector) names
    kernel 11's own item; the Pallas kernel takes any width."""
    if item is None:
        assert tnorm.check_ln_bwd_limits(cols, dtype) is None
    else:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            tnorm.check_ln_bwd_limits(cols, dtype)


def test_wrapper_counts_no_launch_on_the_cpu():
    before = tnorm.layernorm_bwd.launches
    x, dy, w, _ = _ln_inputs(8, 16, seed=0)
    tnorm.layernorm_bwd(t(x), t(dy), t(w), EPS)
    assert tnorm.layernorm_bwd.launches == before


# ---------------------------------------------------------------------------
# LayerNormFn: forward bit-identical, gradients against both references
# ---------------------------------------------------------------------------


def _modules(c, w, b, eps=EPS):
    mods = []
    for flag in (False, True):
        m = tnorm.LayerNorm(c, device=CPU, eps=eps, pallas_bwd=flag)
        m.load_state_dict({"weight": t(w), "bias": t(b)})
        mods.append(m)
    return mods


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
def test_forward_is_bit_identical_to_the_default_route(dtype, grad):
    x, _, w, b = _ln_inputs(6 * 9, 64, seed=2)
    xt = t(x).reshape(6, 9, 64).to(dtype)
    plain, fused = _modules(64, w, b)
    with torch.set_grad_enabled(grad):
        a, bb = plain(xt), fused(xt)
    assert a.dtype == bb.dtype == dtype
    assert torch.equal(a, bb)
    want = _layernorm_fwd_expr(jnp.asarray(n(xt), jnp.float32 if dtype == torch.float32
                                           else jnp.bfloat16), jnp.asarray(w), jnp.asarray(b), EPS)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=0, atol=4e-2)
    np.testing.assert_allclose(n(bb), np.asarray(want, np.float32), **tol)


def _fn_grads(module, x, g):
    xt = x.clone().requires_grad_(True)
    module.zero_grad()
    module(xt).backward(g)
    return xt.grad, module.weight.grad, module.bias.grad


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_function_gradients_match_autograd_and_jax(eps):
    x, dy, w, b = _ln_inputs(4 * 11, 64, seed=3)
    shape = (4, 11, 64)
    plain, fused = _modules(64, w, b, eps)
    got = _fn_grads(fused, t(x).reshape(shape), t(dy).reshape(shape))
    via_autograd = _fn_grads(plain, t(x).reshape(shape), t(dy).reshape(shape))
    _, vjp = jax.vjp(lambda *a: layernorm_pallas_bwd(*a, epsilon=eps),
                     jnp.asarray(x).reshape(shape), jnp.asarray(w), jnp.asarray(b))
    via_jax = vjp(jnp.asarray(dy).reshape(shape))
    assert got[0].shape == shape and got[1].dtype == got[2].dtype == torch.float32
    for want in (via_autograd, via_jax):
        for name, a, wnt in zip(("dx", "dweight", "dbias"), got, want):
            np.testing.assert_allclose(n(a), n(wnt), rtol=1e-4, atol=1e-5, err_msg=name)


def test_bf16_function_passes_f32_gradients_to_its_f32_parameters():
    """The default route's gradient reaches the f32 parameters through the
    differentiable bf16 cast; this route hands them f32 sums directly."""
    x, dy, w, b = _ln_inputs(5 * 7, 64, seed=4)
    shape = (5, 7, 64)
    plain, fused = _modules(64, w, b)
    with torch.no_grad():  # a cached cast from an eval call must not leak into training
        fused(t(x).reshape(shape).to(torch.bfloat16))
    xb, gb = t(x).reshape(shape).to(torch.bfloat16), t(dy).reshape(shape).to(torch.bfloat16)
    got = _fn_grads(fused, xb, gb)
    want = _fn_grads(plain, xb.float(), gb.float())
    assert got[0].dtype == torch.bfloat16
    for name, a, wnt in zip(("dx", "dweight", "dbias"), got, want):
        assert a is not None, f"{name}: no gradient"
        scale = wnt.abs().max().item()
        np.testing.assert_allclose(n(a), n(wnt), rtol=0, atol=2e-2 * scale, err_msg=name)
    assert got[1].dtype == got[2].dtype == torch.float32


def test_backward_saves_x_and_weight_alone():
    x, _, w, b = _ln_inputs(12, 64, seed=6)
    _, fused = _modules(64, w, b)
    xt = t(x).requires_grad_(True)
    y = fused(xt)
    saved = y.grad_fn.saved_tensors
    assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    assert len(saved) == 2 and saved[0].shape == (12, 64) and saved[1].shape == (64,)


# ---------------------------------------------------------------------------
# The flag through the model
# ---------------------------------------------------------------------------

NUM_CLASSES, CAMERA_NUM = 8, 4


def _cfg(flash: bool, ln_bwd: bool = True, dtype: str = "float32"):
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.TPU.USE_FLASH_ATTENTION = flash
    cfg.TPU.PALLAS_LN_BWD = ln_bwd
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.SOLVER.BASE_LR = 3.5e-4
    return cfg


@pytest.mark.parametrize("flash", [True, False], ids=["fused", "unfused"])
def test_flag_reaches_the_layernorms_jax_gives_it(flash):
    model = make_model(_cfg(flash), NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    base = model.backbone.base
    assert not base.ln_pre.pallas_bwd and not base.ln_post.pallas_bwd
    for blk in base.resblocks:
        assert blk.ln_2.pallas_bwd
        assert blk.ln_1.pallas_bwd == (not flash)
    others = [k for k, m in model.named_modules()
              if isinstance(m, tnorm.LayerNorm) and m.pallas_bwd and "resblocks" not in k]
    assert others == []
    off = make_model(_cfg(flash, ln_bwd=False), NUM_CLASSES, CAMERA_NUM, device=CPU,
                     generator=generator())
    assert not any(m.pallas_bwd for m in off.modules() if isinstance(m, tnorm.LayerNorm))


def test_imagenet_vit_never_takes_the_flag():
    cfg = _cfg(True)
    cfg.MODEL.TRANSFORMER_TYPE = "vit_base_patch16_224"
    cfg.TPU.BACKBONE_WIDTH = cfg.TPU.BACKBONE_HEADS = -1
    cfg.TPU.BACKBONE_DEPTH = 1
    model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    assert not any(m.pallas_bwd for m in model.modules() if isinstance(m, tnorm.LayerNorm))


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


@functools.cache
def _jax_step(flash: bool):
    """JAX's train step of the tiny flagship with PALLAS_LN_BWD: (cfg, inputs,
    variables, loss, grads, state after the step).  Callers turn flax's
    dropout off."""
    cfg = _cfg(flash)
    cfg.freeze()
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(9)
    images = rng.standard_normal((16, 3, h, w, 3)).astype(np.float32)
    pids = np.repeat(np.arange(8), 2).astype(np.int32)
    cams = rng.integers(0, CAMERA_NUM, 16).astype(np.int32)
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, images[:2], cams[:2], train=False, seed=9)
    batch = types.SimpleNamespace(images=images[:2], camids=cams[:2], viewids=cams[:2] * 0)
    jstate, tx, ctx, _ = j_create_train_state(cfg, jmodel, jax.random.PRNGKey(0), batch, 4)
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
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss_value), rtol=1e-6)
    return cfg, (images, pids, cams), variables, float(j_loss_value), j_grads, new_jstate


@pytest.mark.parametrize("flash", [True, False], ids=["fused", "unfused"])
def test_one_train_step_with_the_flag_matches_jax(flash, no_flax_dropout, monkeypatch):
    cfg, (images, pids, cams), variables, j_loss, j_grads, new_jstate = _jax_step(flash)
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator()),
                     variables)
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    calls = []
    real = tnorm.layernorm_bwd
    monkeypatch.setattr(tnorm, "layernorm_bwd", lambda *a: calls.append(a[0].shape) or real(*a))
    loss, _, grads = loss_and_grads(cfg, port, tl.make_loss_fn(cfg, NUM_CLASSES), t(images),
                                    t(pids).long(), t(cams).long(), None)
    depth = len(port.backbone.base.resblocks)
    tokens = port.backbone.base.positional_embedding.shape[0]
    # ln_2 of every block, and ln_1 where the attention is unfused; each over
    # the stacked 3B batch's rows.
    assert calls == [(3 * 16 * tokens, port.backbone.base.width)] * (depth * (1 if flash else 2))
    np.testing.assert_allclose(n(loss), j_loss, rtol=1e-5)
    want_grads = convert_flax_variables({"params": j_grads,
                                         "batch_stats": variables["batch_stats"]}, port)
    assert set(grads) == {k for k, _ in port.named_parameters()}
    # As tests/test_torch_train.py holds the default route: per tensor 1e-4 of
    # its largest element, and 1e-6 of the model's largest.
    top = max(np.abs(n(want_grads[k])).max() for k in grads)
    for k, g in grads.items():
        w = n(want_grads[k])
        np.testing.assert_allclose(n(g), w, rtol=1e-3, atol=1e-4 * np.abs(w).max() + 1e-6 * top,
                                   err_msg=k)
    state = create_train_state(cfg, port, 4)
    state.optimizer.step(grads)
    want = convert_flax_variables({"params": new_jstate.params,
                                   "batch_stats": new_jstate.batch_stats}, port)
    # Adam's first step moves a weight by lr * g / (|g| + 1e-8), about
    # lr * sign(g): where the gradient stands clear of summation noise the
    # parameters agree to 1e-6; where it is zero up to noise (the key bias
    # under the softmax, say) each side may move by up to lr.
    lr = state.schedule(0)
    for k, v in port.state_dict().items():
        d = np.abs(n(v) - n(want[k]))
        assert d.max() <= 2 * lr + 1e-6, k
        if k in grads:
            w = np.abs(n(want_grads[k]))
            d = d[w > 1e-3 * w.max() + 1e-6 * top]
        assert d.size == 0 or d.max() <= 1e-6, (k, d.max())


@pytest.mark.parametrize("flash", [True, False], ids=["fused", "unfused"])
def test_bf16_step_with_the_flag_updates_every_parameter(flash):
    """Every parameter of a bf16 model, each LayerNorm's weight and bias
    among them, gets a gradient and moves."""
    cfg = _cfg(flash, dtype="bfloat16")
    cfg.freeze()
    ds = SyntheticTriModal(num_pids=8, imgs_per_pid=4, image_size=tuple(cfg.INPUT.SIZE_TRAIN))
    train = dc.DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True, cfg=cfg,
                                       device=CPU)
    sampler = RandomIdentitySampler(ds.train, cfg.SOLVER.IMS_PER_BATCH,
                                    cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED)
    model = make_model(cfg, ds.num_train_pids, ds.num_train_cams, device=CPU,
                       generator=generator(0))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model, 2)
    step = build_train_step(cfg, model, state, train)
    order = torch.from_numpy(sampler.epoch_indices(1))
    bs = cfg.SOLVER.IMS_PER_BATCH
    # Two steps: SDTPS's modal-weight MLPs end in a zero-initialised layer,
    # which passes no gradient back to their zero biases in the first.
    for i in range(2):
        assert np.isfinite(n(step(order[i * bs:(i + 1) * bs])["loss"]))
    after = model.state_dict()
    stale = [k for k, v in after.items() if torch.equal(v, before[k])]
    assert stale == [], stale
    ln_keys = [k for k in after if ".ln_1." in k or ".ln_2." in k]
    assert len(ln_keys) == 4 * len(model.backbone.base.resblocks)


# ---------------------------------------------------------------------------
# chip_smoke.py's checks of kernel 11, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_layernorm_phase_passes_on_the_plain_version():
    """Phase 14's LayerNorm part at small shapes on the CPU, where the
    wrapper is its plain version: every bound holds against the f64
    computation, and the reruns are bit-identical."""
    import chip_smoke as cs

    errors = cs.phase_ln_bwd_kernel(CPU, cases=(((50, 64), torch.bfloat16),
                                                ((7, 48), torch.float32)))
    assert errors == {"layernorm_bwd": 0.0}
    x, dy, w = cs.ln_bwd_inputs((9, 32), CPU, seed=1, dtype=torch.float32)
    for got, want in zip(tnorm.layernorm_bwd_plain(x, dy, w, cs.LN_EPS),
                         cs.ln_bwd_f64(x, dy, w, cs.LN_EPS)):
        np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-5)


def test_chip_smoke_bound_is_the_larger_of_bytes_and_operations():
    import chip_smoke as cs

    # Kernel 11 at batch 64: 3 R C bf16 values and three f32 vectors; 12 R C f32 operations.
    moved = 3 * 24768 * 768 * 2 + 3 * 768 * 4
    ms, by = cs.roofline(12 * 24768 * 768, cs.F32_PEAK_TFLOPS, moved)
    assert by == "bytes" and ms == pytest.approx(moved / 3.35e9)
    # Kernel 12 at 1,600 queries among 4,800: 2 nq n n f32 operations.
    flops = 2 * 1600 * 4800 * 4800
    ms, by = cs.roofline(flops, cs.F32_PEAK_TFLOPS, (1600 * 4800 * 2 + 4800 * 4800) * 4)
    assert by == "operations" and ms == pytest.approx(flops / 67e9)
    assert cs.tensor_bytes([torch.zeros(3, 4), torch.zeros(5, dtype=torch.bfloat16)]) == 58
