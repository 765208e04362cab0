"""TPU.INT8_MLP in the port against the JAX package on the CPU.

ops/quant.py::int8_dense: the f32 forward bitwise JAX's, dynamic and static,
at 2-D and batched shapes; the exact backward (dx, dW within 1e-6 of the
largest element); bf16 within one bf16 ulp.  A copy that rounds toward zero
in place of half to even (the misquantized control) must fail each bound.
CLIPMlp(int8_fwd=) keeps the Dense parameters.  The tiny flagship with
INT8_MLP "dynamic" and "static" (f32, the fused attention on, so the port's
rule that keeps the fused MLP off is exercised) from JAX's weights:

  * the eval embedding: mean |diff| <= 1e-3 of the mean |embedding| and max
    <= 1e-2 of the largest.  A quantized activation that falls on the other
    side of a .5 boundary between the packages (upstream f32 round-off; the
    count is printed) moves the embedding by up to ~3e-3 of its largest;
  * one training forward's loss within 1e-3 (relative), the gradients'
    whole-model cosine >= 1 - 1e-5, each tensor within 1e-2 of its largest
    element plus 1e-2 of the model's largest.

The control reads 1.1e-2 to 1.6e-2 on the loss, 1.7e-2 to 4.8e-2 off the
cosine and 0.38 to 0.57 on the worst tensor.
"""

import contextlib
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.losses import losses as jl
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.models.clip_vit import CLIPMlp as JCLIPMlp
from demo2_tpu.ops.quant import int8_dense as j_int8_dense
from demo2_tpu_torch.engine.train import loss_and_grads
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.models import clip_vit, make_model
from demo2_tpu_torch.ops import quant
from demo2_tpu_torch.ops.quant import check_int_mm_shape, int8_dense
from demo2_tpu_torch.utils.converters import convert_flax_variables
from torch_port_helpers import CPU, generator, load_port, n, random_variables, t

NUM_CLASSES, CAMERA_NUM, BATCH = 8, 4, 16
MODES = ("dynamic", "static")
SCALES = {"dynamic": 0.0, "static": 10.0 / 127.0}
GRAD_REL = 1e-6
EMB_MEAN_REL, EMB_MAX_REL = 1e-3, 1e-2
LOSS_REL, GRAD_COS_GAP, GRAD_TENSOR_REL = 1e-3, 1e-5, 1e-2


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quantize_toward_zero(xf, s):
    return torch.clamp(torch.trunc(xf / s), -127, 127).to(torch.int8)


@contextlib.contextmanager
def misquantized():
    """The port rounding toward zero in place of half to even."""
    kept = quant.quantize
    quant.quantize = _quantize_toward_zero
    try:
        yield
    finally:
        quant.quantize = kept


def _operands(shape, n_out, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    w = (rng.standard_normal((shape[-1], n_out)) * 0.1).astype(np.float32)  # JAX's (K, N)
    return x, w


def _jax_dense(x, w, mode, dtype=jnp.float32):
    """JAX's int8_dense, called as the JAX package calls it (op by op)."""
    return np.asarray(j_int8_dense(jnp.asarray(x, dtype), jnp.asarray(w),
                                   jnp.asarray(SCALES[mode], jnp.float32)).astype(jnp.float32))


@pytest.mark.parametrize("shape,n_out", [((32, 48), 24), ((2, 5, 16), 24), ((3, 43, 64), 256)])
@pytest.mark.parametrize("mode", MODES)
def test_int8_dense_forward_is_jaxs_bitwise(mode, shape, n_out):
    x, w = _operands(shape, n_out)
    want = _jax_dense(x, w, mode)
    got = int8_dense(t(x), t(w.T.copy()), SCALES[mode])
    assert got.shape == (*shape[:-1], n_out) and got.dtype == torch.float32
    np.testing.assert_array_equal(n(got), want)
    with misquantized():
        wrong = n(int8_dense(t(x), t(w.T.copy()), SCALES[mode]))
    assert not np.array_equal(wrong, want)


@pytest.mark.parametrize("mode", MODES)
def test_int8_dense_backward_is_the_unquantized_one(mode):
    x, w = _operands((2, 40, 64), 96, seed=1)
    g = np.random.default_rng(2).standard_normal((2, 40, 96)).astype(np.float32)
    scale = jnp.asarray(SCALES[mode], jnp.float32)
    dx_j, dw_j = jax.jit(jax.grad(lambda a, b: jnp.sum(j_int8_dense(a, b, scale) * g),
                                  argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = t(x).requires_grad_(True), t(w.T.copy()).requires_grad_(True)
    (int8_dense(xt, wt, SCALES[mode]) * t(g)).sum().backward()
    for got, want in ((n(xt.grad), np.asarray(dx_j)), (n(wt.grad).T, np.asarray(dw_j))):
        assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max()
    # Not the quantized product's gradient: the exact dx = g W.
    np.testing.assert_allclose(n(xt.grad), g @ w.T, rtol=1e-5, atol=1e-5)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 at each |v| (2^(e - 7))."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("mode", MODES)
def test_int8_dense_bf16_within_one_ulp(mode):
    x, w = _operands((4, 33, 64), 128, seed=3)
    xb = t(x).bfloat16()
    want = _jax_dense(n(xb), w, mode, jnp.bfloat16)
    got = int8_dense(xb, t(w.T.copy()), SCALES[mode])
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(n(got) - want) <= _bf16_ulp(want))
    with misquantized():
        wrong = n(int8_dense(xb, t(w.T.copy()), SCALES[mode]))
    assert not np.all(np.abs(wrong - want) <= _bf16_ulp(want))
    # The backward in g's dtype: dx bf16 within one ulp of JAX's.
    g = np.random.default_rng(4).standard_normal((4, 33, 128)).astype(np.float32)
    dx_j = jax.jit(jax.grad(lambda a: jnp.sum(j_int8_dense(a, jnp.asarray(w), jnp.asarray(
        SCALES[mode], jnp.float32)).astype(jnp.float32) * g)))(jnp.asarray(n(xb), jnp.bfloat16))
    xg = xb.clone().requires_grad_(True)
    (int8_dense(xg, t(w.T.copy()), SCALES[mode]).float() * t(g)).sum().backward()
    want_dx = np.asarray(dx_j.astype(jnp.float32))
    assert xg.grad.dtype == torch.bfloat16
    assert np.all(np.abs(n(xg.grad) - want_dx) <= _bf16_ulp(want_dx))


def test_int8_product_shapes_cuda_refuses_raise_naming_the_shape():
    for m, k, nn_ in ((24768, 768, 3072), (24768, 3072, 768), (387, 768, 3072)):
        check_int_mm_shape(m, k, nn_)  # the flagship's, batch 64 and batch 1
    for m, k, nn_ in ((16, 768, 3072), (387, 100, 3072), (387, 768, 3070)):
        with pytest.raises(ValueError, match=rf"\({m}, {k}\) x \({k}, {nn_}\)"):
            check_int_mm_shape(m, k, nn_)


@pytest.mark.parametrize("mode", MODES)
def test_clip_mlp_int8_keeps_the_dense_parameters_and_matches_jax(mode):
    x = np.random.default_rng(5).standard_normal((2, 9, 32)).astype(np.float32)
    jm = JCLIPMlp(32, int8_fwd=mode)
    variables = random_variables(jm, x, seed=6)
    off_tree = random_variables(JCLIPMlp(32), x, seed=6)
    assert (set(flax.traverse_util.flatten_dict(variables))
            == set(flax.traverse_util.flatten_dict(off_tree)))
    port = load_port(clip_vit.CLIPMlp(32, dtype=torch.float32, device=CPU, generator=generator(),
                                      int8_fwd=mode), variables)
    plain = clip_vit.CLIPMlp(32, dtype=torch.float32, device=CPU, generator=generator())
    assert set(port.state_dict()) == set(plain.state_dict())
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    got = port(t(x))
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
    plain.load_state_dict(port.state_dict())
    assert not np.allclose(n(plain(t(x))), want, rtol=1e-5, atol=1e-5)  # it is quantized
    got.square().sum().backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in port.parameters())


# ---------------------------------------------------------------------------
# The tiny flagship under INT8_MLP
# ---------------------------------------------------------------------------


def _cfg(mode):
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.TPU.USE_FLASH_ATTENTION = True
    cfg.MODEL.SDTPS_SPARSE_RATIO = 0.7
    cfg.TPU.INT8_MLP = mode
    return cfg.freeze()


def _no_flax_dropout(self, x, deterministic=None, rng=None):
    return x


@functools.cache
def _jax_case(mode):
    """JAX's eval embedding (with the blocks' ln_2 outputs) and one training
    forward's loss and gradients, dropout off, from random variables."""
    cfg = _cfg(mode)
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(8)
    images = rng.standard_normal((BATCH, 3, h, w, 3)).astype(np.float32)
    pids = np.repeat(np.arange(BATCH // 2), 2).astype(np.int32)
    cams = rng.integers(0, CAMERA_NUM, BATCH).astype(np.int32)
    jm = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jm, images[:2], cams[:2], train=False, seed=8)
    loss_fn = jl.make_loss_fn(cfg, NUM_CLASSES)

    def train_loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, images,
                          cams, None, None, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                          mutable=["batch_stats"])
        wts = jl.branch_weights(cfg, out["branches"].keys())
        return sum(wts[k] * loss_fn(lg, f, pids) for k, (lg, f) in out["branches"].items())

    def train_and_eval(v):  # one XLA program: one compile
        return (jax.value_and_grad(train_loss)(v["params"]),
                jm.apply(v, images[:3], cams[:3], None, None, train=False,
                         capture_intermediates=True))

    kept = flax.linen.Dropout.__call__
    flax.linen.Dropout.__call__ = _no_flax_dropout
    try:
        (loss, grads), (out, inter) = jax.jit(train_and_eval)(variables)
    finally:
        flax.linen.Dropout.__call__ = kept
    ln2 = [np.asarray(inter["intermediates"]["backbone"]["base"][f"resblocks_{i}"]["ln_2"]
                      ["__call__"][0]) for i in range(cfg.TPU.BACKBONE_DEPTH)]
    return dict(cfg=cfg, images=images, pids=pids, cams=cams, variables=variables,
                loss=float(loss), grads=grads, embedding=np.asarray(out["embedding"]), ln2=ln2)


def _port(case):
    port = load_port(make_model(case["cfg"], NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), case["variables"])
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    return port


def _quantized_inputs(block, x, mode):
    """The int8 activations of the block's two MLP GEMMs for ln_2 output x,
    by the port's functions (the second GEMM's input recomputed from x)."""
    s = SCALES[mode]
    xf = torch.as_tensor(x).reshape(-1, x.shape[-1]).float()
    mlp = block.mlp
    h = int8_dense(xf, mlp.c_fc.weight.detach(), s) + mlp.c_fc.bias.detach()
    hf = clip_vit.quick_gelu(h)
    return [quant.quantize(v, quant.act_scale_of(v, s)) for v in (xf, hf)]


def _eval_errors(port, case):
    with torch.no_grad():
        got = n(port(t(case["images"][:3]), t(case["cams"][:3]).long())["embedding"])
    want = case["embedding"]
    err = np.abs(got - want)
    return err.mean() / np.abs(want).mean(), err.max() / np.abs(want).max()


@pytest.mark.parametrize("mode", MODES)
def test_tiny_int8_flagship_eval_matches_jax(mode, monkeypatch):
    case = _jax_case(mode)
    port = _port(case)
    ln2 = []
    hooks = [blk.ln_2.register_forward_hook(lambda m, a, o: ln2.append(o.detach()))
             for blk in port.backbone.base.resblocks]

    def no_fused_mlp(*args, **kwargs):
        raise AssertionError("INT8_MLP must keep the fused MLP off at eval")

    monkeypatch.setattr(clip_vit, "fused_mlp", no_fused_mlp)
    mean_rel, max_rel = _eval_errors(port, case)
    for hk in hooks:
        hk.remove()
    differ = total = 0
    for blk, mine, theirs in zip(port.backbone.base.resblocks, ln2, case["ln2"]):
        for a, b in zip(_quantized_inputs(blk, mine, mode), _quantized_inputs(blk, theirs, mode)):
            differ += int((a != b).sum())
            total += a.numel()
    print(f"\n[int8 {mode}] quantized activations that differ from JAX's: {differ} of {total}; "
          f"embedding mean / max error {mean_rel:.3e} / {max_rel:.3e}")
    assert differ <= 0.01 * total
    assert mean_rel <= EMB_MEAN_REL and max_rel <= EMB_MAX_REL
    with misquantized():
        mean_c, max_c = _eval_errors(_port(case), case)
    assert mean_c > EMB_MEAN_REL, (mean_c, max_c)


def _train_errors(port, case):
    cfg = case["cfg"]
    loss, _, grads = loss_and_grads(cfg, port, tl.make_loss_fn(cfg, NUM_CLASSES),
                                    t(case["images"]), t(case["pids"]).long(),
                                    t(case["cams"]).long(), None)
    want = convert_flax_variables({"params": case["grads"],
                                   "batch_stats": case["variables"]["batch_stats"]}, port)
    assert set(grads) == {k for k, _ in port.named_parameters()}
    g = torch.cat([grads[k].double().flatten() for k in grads])
    w = torch.cat([want[k].double().flatten() for k in grads])
    top = max(want[k].abs().max().item() for k in grads)
    worst = max(((grads[k] - want[k]).abs().max()
                 / (want[k].abs().max() + GRAD_TENSOR_REL * top)).item() for k in grads)
    return (abs(loss.item() - case["loss"]) / abs(case["loss"]),
            1.0 - (g @ w / (g.norm() * w.norm())).item(), worst)


@pytest.mark.parametrize("mode", MODES)
def test_tiny_int8_flagship_train_step_matches_jax(mode):
    case = _jax_case(mode)
    loss_rel, cos_gap, worst = _train_errors(_port(case), case)
    print(f"\n[int8 {mode}] train step vs JAX: loss {loss_rel:.3e}, 1 - cosine {cos_gap:.3e}, "
          f"worst tensor {worst:.3e}")
    assert loss_rel <= LOSS_REL and cos_gap <= GRAD_COS_GAP and worst <= GRAD_TENSOR_REL
    with misquantized():
        control = _train_errors(_port(case), case)
    assert (control[0] > LOSS_REL and control[1] > GRAD_COS_GAP
            and control[2] > GRAD_TENSOR_REL), control
