"""The port's training kernels' plain versions against the Pallas kernels.

On the CPU the wrappers of kernels 3, 4 and 7 take their plain PyTorch
versions; those are held here against the Pallas kernels they replace, run in
interpret mode as tests/test_pallas_kernels.py runs them, in f32.  The TPU
saves probs in a head-concat layout tied to its block-size policy
(`_choose_bb`); the port's layout is (B, H, S, S16), and the tests move the
values between the two.  FusedAttentionBlockFn, which runs the plain versions
inside the same autograd structure on the CPU as the kernels on the card, is
held against `_fused_bwd` and against autodiff of `_reference_impl`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.ops.fused_block import _fused_bwd, _fused_fwd_impl, _reference_impl
from demo2_tpu.ops.packed_attention import _packed_bwd_saved, _packed_bwd_saved_db
from demo2_tpu_torch.ops import fused_block as fb
from demo2_tpu_torch.ops import packed_attention as pa
from demo2_tpu_torch.ops.linear import Linear, cached_cast
from demo2_tpu_torch.ops.norm import LayerNorm
from demo2_tpu_torch.models.clip_vit import PatchConv
from torch_port_helpers import (CPU, generator, jax_to_port_probs, n, port_to_jax_probs,
                                t)

# f32 on both sides; only the summation order differs.
TOL = dict(rtol=1e-4, atol=1e-4)
# Gradients pass through more sums (LayerNorm backward, dW over B*S rows).
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _attn_inputs(b, s, c, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    return (f(b, s, c), 1.0 + f(c, std=0.1), f(c, std=0.1), f(c, 3 * c, std=c ** -0.5),
            f(3 * c, std=0.1), f(c, c, std=c ** -0.5), f(c, std=0.1))


# b = 4, 12 and 16 give the TPU block sizes 4, 4 and 8 (12 is the case where
# two block-size policies once disagreed); S = 9 pads to 16 there.
FWD_CASES = [(4, 9, 32, 2), (12, 9, 32, 4), (16, 5, 64, 2)]


@pytest.mark.parametrize("b,s,c,h", FWD_CASES)
def test_training_forward_plain_matches_pallas_kernel(b, s, c, h):
    x, lns, lnb, wqkv, bqkv, wout, bout = _attn_inputs(b, s, c, seed=b + s)
    scale = (c // h) ** -0.5
    out, qkv, attn, _, probs = _fused_fwd_impl(
        *(jnp.asarray(a) for a in (x, lns, lnb, wqkv, bqkv, wout, bout)), h, scale,
        interpret=True)
    got = fb.fused_attention_block_train(t(x), t(lns), t(lnb), t(wqkv.T.copy()), t(bqkv),
                                         t(wout.T.copy()), t(bout), num_heads=h, scale=scale)
    assert got[3].shape == pa.probs_shape(b, h, s)
    np.testing.assert_allclose(n(got[0]), np.asarray(out), **TOL)
    np.testing.assert_allclose(n(got[1]), np.asarray(qkv)[:, :s], **TOL)
    np.testing.assert_allclose(n(got[2]), np.asarray(attn)[:, :s], **TOL)
    np.testing.assert_allclose(n(got[3]), jax_to_port_probs(probs, b, h, s), **TOL)
    assert not n(got[3])[..., s:].any(), "probs columns past S must be zero"


def _bwd_inputs(b, s, c, h, seed):
    """Packed qkv, saved probs (softmax rows, zero past S) and dO."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * c)).astype(np.float32)
    logits = rng.standard_normal((b, h, s, s)).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    probs = np.pad(p, ((0, 0), (0, 0), (0, 0), (0, pa.probs_cols(s) - s)))
    do = rng.standard_normal((b, s, c)).astype(np.float32)
    return qkv, probs.astype(np.float32), do


@pytest.mark.parametrize("with_db", [True, False], ids=["db", "no_db"])
@pytest.mark.parametrize("b,s,c,h", [(4, 9, 32, 2), (12, 13, 64, 4)])
def test_saved_probs_backward_plain_matches_pallas_kernel(b, s, c, h, with_db):
    qkv, probs, do = _bwd_inputs(b, s, c, h, seed=b * s)
    scale = (c // h) ** -0.5
    s_pad = -(-s // 8) * 8
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, s_pad - s), (0, 0))))
    jprobs = jnp.asarray(port_to_jax_probs(probs, s_pad))
    if with_db:
        want, want_db = _packed_bwd_saved_db(h, scale, pad(qkv), jprobs, pad(do), interpret=True)
        got, got_db = pa.attention_bwd_saved_db(t(qkv), t(probs), t(do), num_heads=h,
                                                scale=scale)
        np.testing.assert_allclose(n(got_db), np.asarray(want_db), **TOL)
    else:
        want = _packed_bwd_saved(h, scale, pad(qkv), jprobs, pad(do), interpret=True)
        got = pa.attention_bwd_saved(t(qkv), t(probs), t(do), num_heads=h, scale=scale)
    np.testing.assert_allclose(n(got), np.asarray(want)[:, :s], **TOL)
    assert not np.asarray(want)[:, s:].any()  # the TPU's padded rows carry nothing


# bf16 on both sides with the same rounding points (dS once, then dq, dk, dv):
# the two differ only where an f32 sum taken in another order lands on the
# other side of a bf16 rounding.  chip_smoke.py holds kernel 4 to this mean on
# the card; here the plain version it is held against meets it against the
# Pallas kernel, and the misrounded control does not.
ROUNDING_CASES = [(4, 9, 128, 2), (8, 13, 128, 2)]


def _bf16_saved_inputs(b, s, c, h, seed):
    """_bwd_inputs with the probs as a bf16 forward saves them."""
    qkv, probs, do = _bwd_inputs(b, s, c, h, seed)
    bf = lambda a: t(a).to(torch.bfloat16)
    return bf(qkv), bf(probs), bf(do)


def _pallas_saved_db_bf16(qkv, probs, do, h, scale):
    """_packed_bwd_saved_db in interpret mode on the same bf16 values."""
    s = qkv.shape[1]
    s_pad = -(-s // 8) * 8
    pad = lambda a: jnp.asarray(np.pad(n(a.float()), ((0, 0), (0, s_pad - s), (0, 0))),
                                jnp.bfloat16)
    jprobs = jnp.asarray(port_to_jax_probs(n(probs.float()), s_pad), jnp.bfloat16)
    dqkv, db = _packed_bwd_saved_db(h, scale, pad(qkv), jprobs, pad(do), interpret=True)
    return t(np.asarray(dqkv, np.float32)[:, :s]), np.asarray(db)


@pytest.mark.parametrize("b,s,c,h", ROUNDING_CASES)
def test_saved_probs_backward_plain_rounds_where_the_pallas_kernel_rounds_bf16(b, s, c, h):
    import chip_smoke as cs

    qkv, probs, do = _bf16_saved_inputs(b, s, c, h, seed=b + s)
    scale = (c // h) ** -0.5
    want, want_db = _pallas_saved_db_bf16(qkv, probs, do, h, scale)
    got, got_db = pa.attention_bwd_saved_db(qkv, probs, do, num_heads=h, scale=scale)
    assert got.dtype == torch.bfloat16 and got_db.dtype == torch.float32
    assert cs.mean_err(got, want) <= cs.ROUNDING_MEAN_TOL
    # db sums the rounded dqkv: a flipped rounding moves one term by a bf16 ulp.
    np.testing.assert_allclose(n(got_db), want_db, rtol=0,
                               atol=cs.DB_REL * float(np.abs(want_db).max()))


@pytest.mark.parametrize("b,s,c,h", ROUNDING_CASES)
def test_misrounded_control_of_kernel_4_fails_the_rounding_bound(b, s, c, h):
    """The control of chip_smoke.py's phase 5, dS left in f32 for the dQ and
    dK products, is further than ROUNDING_MEAN_TOL from the plain version (and
    from the Pallas kernel), so the bound can tell where a kernel rounds; dv,
    which no dS enters, is the plain version's."""
    import chip_smoke as cs

    qkv, probs, do = _bf16_saved_inputs(b, s, c, h, seed=b + s)
    kw = dict(num_heads=h, scale=(c // h) ** -0.5)
    plain = pa.attention_bwd_saved_plain(qkv, probs, do, with_db=False, **kw)
    wrong = cs._misrounded_saved_bwd(qkv, probs, do, **kw)
    want, _ = _pallas_saved_db_bf16(qkv, probs, do, h, kw["scale"])
    assert wrong.shape == plain.shape and wrong.dtype == plain.dtype == torch.bfloat16
    assert cs.mean_err(wrong, plain) > 10 * cs.ROUNDING_MEAN_TOL
    assert cs.mean_err(wrong, want) > 10 * cs.ROUNDING_MEAN_TOL
    assert torch.equal(wrong[..., 2 * c:], plain[..., 2 * c:])


SAVED_EDGES = [(2, 144, 2), (2, 16, 2), (3, 1, 2), (2, 40, 2), (2, 77, 3)]  # (batch, S, heads)


def test_chip_smoke_train_kernel_phase_checks_kernel_4_at_the_edges(capsys):
    """Phase 5 of chip_smoke.py on the CPU, where each wrapper is its plain
    version: kernel 4 is held at a main shape with its control and at the
    edges of its tiling, as packed qkv of phase 9's edge sizes, with dqkv and
    db compared over two runs and kernel 7 against kernel 4 at each."""
    import chip_smoke as cs

    edges = [(b, s, 3 * heads * 64) for b, s, heads in SAVED_EDGES]
    errors = cs.phase_train_kernels(CPU, shapes=((4, 9, 128),), edges=edges)
    assert errors == {"fused_attention_block_train": 0.0, "attention_bwd_saved_db": 0.0,
                      "attention_bwd_saved": 0.0}
    out = capsys.readouterr().out
    for shape in [(4, 9, 384)] + [e for e in edges if e[1] > 1]:
        assert f"kernel 4 dqkv {shape}: control with dS left in f32" in out
    for shape in [(4, 9, 384)] + edges:
        assert f"kernel 4 dqkv {shape}: vs plain bf16 max 0.000e+00" in out
        assert (f"kernel 4 {shape}: dqkv and db bit-identical over two runs; kernel 7's dqkv "
                f"bitwise equal to kernel 4's") in out
    assert out.count("control with dS left in f32") == 5  # over one key nothing is rounded
    assert cs.SAVED_EDGE_SHAPES == tuple((b, s, 3 * h * d) for b, s, h, d in cs.FLASH_EDGE_SHAPES)


@pytest.mark.parametrize("b,s,c,h", [(4, 9, 32, 2), (12, 9, 32, 4)])
def test_function_grads_match_fused_bwd_and_reference_autodiff(b, s, c, h):
    x, lns, lnb, wqkv, bqkv, wout, bout = _attn_inputs(b, s, c, seed=3 * b + s)
    g = np.random.default_rng(7).standard_normal((b, s, c)).astype(np.float32)
    scale = (c // h) ** -0.5
    jargs = [jnp.asarray(a) for a in (x, lns, lnb, wqkv, bqkv, wout, bout)]
    out, qkv_p, attn_p, x_p, probs = _fused_fwd_impl(*jargs, h, scale, interpret=True)
    res = (x_p, qkv_p, attn_p, probs, jargs[1], jargs[2], jargs[3], jargs[5])
    via_fused_bwd = _fused_bwd(h, scale, res, jnp.asarray(g))
    _, vjp = jax.vjp(lambda *a: _reference_impl(*a, h, scale), *jargs)
    via_autodiff = vjp(jnp.asarray(g))

    leaves = [t(a).requires_grad_(True) for a in
              (x, lns, lnb, wqkv.T.copy(), bqkv, wout.T.copy(), bout)]
    y = fb.fused_attention(*leaves, num_heads=h, scale=scale)
    np.testing.assert_allclose(n(y), np.asarray(out), **TOL)
    y.backward(t(g))
    got = [n(v.grad) for v in leaves]
    got[3], got[5] = got[3].T, got[5].T  # back to the flax (in, out) layout
    for want in (via_fused_bwd, via_autodiff):
        for name, a, w in zip(("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wout", "bout"),
                              got, want):
            np.testing.assert_allclose(a, np.asarray(w), err_msg=name, **GRAD_TOL)


def test_fused_attention_chooses_the_eval_kernel_without_grad():
    x, lns, lnb, wqkv, bqkv, wout, bout = (t(a) for a in _attn_inputs(2, 5, 32, seed=0))
    params = [v.requires_grad_(True) for v in (lns, lnb, wqkv.T.contiguous(), bqkv,
                                               wout.T.contiguous(), bout)]
    with torch.no_grad():
        y = fb.fused_attention(x, *params, num_heads=4, scale=8 ** -0.5)
    assert y.grad_fn is None
    y = fb.fused_attention(x, *params, num_heads=4, scale=8 ** -0.5)
    assert type(y.grad_fn).__name__ == "FusedAttentionBlockFnBackward"


def test_probs_layout_is_one_definition():
    assert pa.probs_cols(129) == 144  # csrc/fused_attention_block.cu's kMaxSeq
    assert pa.probs_cols(16) == 16 and pa.probs_cols(17) == 32
    assert pa.probs_shape(192, 12, 129) == (192, 12, 129, 144)


def test_non_cpu_tensors_never_fall_back_to_the_plain_versions():
    x, lns, lnb, wqkv, bqkv, wout, bout = (t(a).to("meta") for a in _attn_inputs(1, 3, 64, 0))
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_attention_block_train(x, lns, lnb, wqkv, bqkv, wout, bout, num_heads=1,
                                       scale=1.0)
    qkv = torch.zeros(1, 3, 192, device="meta")
    probs = torch.zeros(1, 1, 3, 16, device="meta")
    do = torch.zeros(1, 3, 64, device="meta")
    for fn in (pa.attention_bwd_saved_db, pa.attention_bwd_saved):
        with pytest.raises(ValueError, match="CUDA"):
            fn(qkv, probs, do, num_heads=1, scale=1.0)


# ---------------------------------------------------------------------------
# Gradients through the cached casts (ops/linear.py::cached_cast)
# ---------------------------------------------------------------------------


def _cast_modules(dtype):
    g = generator(3)
    return {
        "linear": Linear(16, 8, dtype=dtype, device=CPU, generator=g),
        "layernorm": LayerNorm(16, device=CPU),
        "patch_conv": PatchConv(16, 16, 16, dtype=dtype, device=CPU, generator=g),
    }


def _inputs(name):
    rng = np.random.default_rng(11)
    shape = (2, 32, 16, 3) if name == "patch_conv" else (4, 16)
    return t(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("name", ["linear", "layernorm", "patch_conv"])
def test_bf16_modules_pass_gradients_to_their_f32_parameters(name):
    """A bf16 module computes on casts of its f32 parameters; the gradient
    must reach those parameters, and agree with the f32 module's within
    bf16 rounding of the forward and backward."""
    mods = {dt: _cast_modules(dt)[name] for dt in (torch.float32, torch.bfloat16)}
    mods[torch.bfloat16].load_state_dict(mods[torch.float32].state_dict())
    with torch.no_grad():  # a cached cast from an eval call must not leak into training
        mods[torch.bfloat16](_inputs(name).to(torch.bfloat16))
    grads = {}
    for dt, mod in mods.items():
        x = _inputs(name).to(dt)
        y = mod(x).float()
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        grads[dt] = {k: p.grad for k, p in mod.named_parameters()}
    for k, g32 in grads[torch.float32].items():
        g16 = grads[torch.bfloat16][k]
        assert g16 is not None, f"{name}.{k}: no gradient reached the f32 parameter"
        assert g16.dtype == torch.float32
        scale = g32.abs().max().item()
        np.testing.assert_allclose(n(g16), n(g32), rtol=0, atol=2e-2 * scale, err_msg=k)


def test_cached_cast_is_reused_only_without_grad():
    lin = _cast_modules(torch.bfloat16)["linear"]
    with torch.no_grad():
        a = cached_cast(lin, "weight", torch.bfloat16)
        assert cached_cast(lin, "weight", torch.bfloat16) is a
    b = cached_cast(lin, "weight", torch.bfloat16)
    assert b.requires_grad and b is not a
    assert cached_cast(lin, "weight", torch.bfloat16) is not b  # one graph per call
