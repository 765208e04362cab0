"""The port's fused-dW attention backward (kernel 8) against the JAX package
on the CPU.

On the CPU the wrapper takes its plain PyTorch version; that is held here
against the Pallas kernel it replaces, `_packed_bwd_fused_dw`, run in
interpret mode as tests/test_pallas_kernels.py runs it: in f32, where only
the summation order differs, and in bf16, where the point is where dq, dk
and dv are rounded.  The block's backward chain with that kernel in its
middle (`attention_block_backward(fused_dw=True)`) is held against the chain
training runs, and against autodiff of `_reference_impl`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.ops.fused_block import _fused_fwd_impl, _reference_impl
from demo2_tpu.ops.packed_attention import _packed_bwd_fused_dw
from demo2_tpu_torch.ops import fused_block as fb
from demo2_tpu_torch.ops import packed_attention as pa
from torch_port_helpers import jax_to_port_probs, n, port_to_jax_probs, t

# f32 on both sides; only the summation order differs.
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
H, C = 4, 32
SCALE = (C // H) ** -0.5


def _block_inputs(b, s, seed):
    """The inputs of test_packed_bwd_fused_dw_matches_separate: x, LayerNorm
    scale 1.05 and bias 0, wqkv (C, 3C) at 0.1, an identity out-projection,
    and a cotangent at 0.3."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    return (f(b, s, C), np.full(C, 1.05, np.float32), np.zeros(C, np.float32),
            f(C, 3 * C, std=0.1), np.zeros(3 * C, np.float32), np.eye(C, dtype=np.float32),
            np.zeros(C, np.float32)), f(b, s, C, std=0.3)


def _ln_output(x_p, lns, lnb):
    xf = x_p.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    return ((xf - mean) * jax.lax.rsqrt(var + 1e-5) * lns + lnb).astype(x_p.dtype)


# b = 16 gives the TPU two grid programs, which accumulate dW and db; b = 12
# is the batch on which two block-size policies once disagreed.
@pytest.mark.parametrize("b", [16, 12])
def test_plain_version_matches_pallas_kernel_f32(b):
    s = 11
    args, g = _block_inputs(b, s, seed=b)
    jargs = [jnp.asarray(a) for a in args]
    _, qkv_p, _, x_p, jprobs = _fused_fwd_impl(*jargs, H, SCALE, interpret=True)
    s_pad = qkv_p.shape[1]
    gp = jnp.pad(jnp.asarray(g), [(0, 0), (0, s_pad - s), (0, 0)])
    t_p = _ln_output(x_p, jargs[1], jargs[2])
    want_dt, want_dw, want_db = _packed_bwd_fused_dw(H, SCALE, qkv_p, jprobs, gp, t_p, jargs[3],
                                                     interpret=True)

    probs = jax_to_port_probs(jprobs, b, H, s)
    got_dt, got_dw, got_db = pa.attention_bwd_fused_dw(
        t(np.asarray(qkv_p)[:, :s]), t(probs), t(g), t(np.asarray(t_p)[:, :s]),
        t(args[3].T.copy()), num_heads=H, scale=SCALE)
    assert got_dt.shape == (b, s, C) and got_dw.shape == (3 * C, C) and got_db.shape == (3 * C,)
    assert got_dw.dtype == got_db.dtype == torch.float32
    np.testing.assert_allclose(n(got_dt), np.asarray(want_dt)[:, :s], **TOL)
    np.testing.assert_allclose(n(got_dw).T, np.asarray(want_dw), **TOL)
    np.testing.assert_allclose(n(got_db), np.asarray(want_db), **TOL)
    assert not np.asarray(want_dt)[:, s:].any()  # the TPU's padded rows carry nothing


def _bf16_inputs(b, s, seed):
    """bf16-exact inputs: packed qkv, saved probs (softmax rows, zero past
    S), dO, the LayerNorm output t and the weight (3C, C)."""
    rng = np.random.default_rng(seed)
    bf = lambda a: t(a.astype(np.float32)).to(torch.bfloat16)
    logits = rng.standard_normal((b, H, s, s))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.pad(p / p.sum(-1, keepdims=True), ((0, 0), (0, 0), (0, 0), (0, pa.probs_cols(s) - s)))
    return (bf(rng.standard_normal((b, s, 3 * C))), bf(p), bf(rng.standard_normal((b, s, C))),
            bf(rng.standard_normal((b, s, C))), bf(rng.standard_normal((3 * C, C)) * C ** -0.5))


def test_plain_version_rounds_where_the_pallas_kernel_rounds_bf16():
    b, s = 16, 11
    qkv, probs, do, tt, w = _bf16_inputs(b, s, seed=3)
    s_pad = -(-s // 8) * 8
    jb = lambda a: jnp.asarray(np.pad(n(a), ((0, 0), (0, s_pad - s), (0, 0))), jnp.bfloat16)
    jprobs = jnp.asarray(port_to_jax_probs(n(probs), s_pad), jnp.bfloat16)
    want_dt, want_dw, want_db = _packed_bwd_fused_dw(
        H, SCALE, jb(qkv), jprobs, jb(do), jb(tt), jnp.asarray(n(w).T, jnp.bfloat16),
        interpret=True)
    got_dt, got_dw, got_db = pa.attention_bwd_fused_dw(qkv, probs, do, tt, w, num_heads=H,
                                                       scale=SCALE)
    assert got_dt.dtype == torch.bfloat16 and want_dt.dtype == jnp.bfloat16
    assert got_dw.dtype == got_db.dtype == torch.float32 and want_dw.dtype == jnp.float32
    # dt is rounded once on both sides, from f32 sums taken in another order:
    # two bf16 ulps (2^-8 each) of the value.
    want = np.asarray(want_dt, np.float32)[:, :s]
    assert (np.abs(n(got_dt) - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()
    # dW and db are f32 sums of the same bf16-rounded dqkv.
    for name, got, wnt in (("dW", n(got_dw).T, np.asarray(want_dw)),
                           ("db", n(got_db), np.asarray(want_db))):
        np.testing.assert_allclose(got, wnt, rtol=0, atol=1e-3 * np.abs(wnt).max(), err_msg=name)


def test_contracting_the_unrounded_dqkv_is_a_different_function():
    """The control of the chip run: dq, dk, dv contracted in f32, without
    their rounding to bf16, moves dt by a fraction of a bf16 ulp on most
    elements, far beyond what the summation order does."""
    qkv, probs, do, tt, w = _bf16_inputs(8, 11, seed=4)
    kw = dict(num_heads=H, scale=SCALE)
    right = pa.attention_bwd_fused_dw_plain(qkv, probs, do, tt, w, **kw)[0].float()
    f32 = pa.attention_bwd_saved_plain(qkv.float(), probs.float(), do.float(), with_db=False,
                                       **kw)
    wrong = (f32.reshape(-1, 3 * C) @ w.float()).to(torch.bfloat16).reshape(right.shape).float()
    rel = ((wrong - right).abs().mean() / right.abs().mean()).item()
    assert 1e-4 < rel < 1e-2


def _chain_grads(args, g, b, s, fused_dw):
    x, lns, lnb, wqkv, bqkv, wout, bout = (t(a) for a in args)
    wqkv_t, wout_t = wqkv.T.contiguous(), wout.T.contiguous()
    out, qkv, attn, probs = fb.fused_attention_block_train(x, lns, lnb, wqkv_t, bqkv, wout_t, bout,
                                                           num_heads=H, scale=SCALE)
    grads = fb.attention_block_backward(x, qkv, attn, probs, lns, lnb, wqkv_t, wout_t, t(g),
                                        num_heads=H, scale=SCALE, fused_dw=fused_dw)
    grads = [n(v) for v in grads]
    grads[3], grads[5] = grads[3].T, grads[5].T  # back to the flax (in, out) layout
    return n(out), grads


@pytest.mark.parametrize("b", [16, 12])
def test_block_backward_through_kernel_8_matches_kernel_4_route_and_autodiff(b):
    s = 11
    args, g = _block_inputs(b, s, seed=20 + b)
    args = list(args)
    rng = np.random.default_rng(b)
    args[5] = (rng.standard_normal((C, C)) * C ** -0.5).astype(np.float32)  # a real out-projection
    out8, via_kernel_8 = _chain_grads(args, g, b, s, fused_dw=True)
    out4, via_kernel_4 = _chain_grads(args, g, b, s, fused_dw=False)
    jargs = [jnp.asarray(a) for a in args]
    want_out, vjp = jax.vjp(lambda *a: _reference_impl(*a, H, SCALE), *jargs)
    via_autodiff = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out8, out4)
    np.testing.assert_allclose(out8, np.asarray(want_out), **TOL)
    names = ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wout", "bout")
    for want in (via_kernel_4, via_autodiff):
        for name, a, w in zip(names, via_kernel_8, want):
            np.testing.assert_allclose(a, np.asarray(w), err_msg=name, **GRAD_TOL)


def test_block_backward_hands_out_only_the_grads_asked_for():
    args, g = _block_inputs(4, 9, seed=1)
    x, lns, lnb, wqkv, bqkv, wout, bout = (t(a) for a in args)
    wqkv_t, wout_t = wqkv.T.contiguous(), wout.T.contiguous()
    _, qkv, attn, probs = fb.fused_attention_block_train(x, lns, lnb, wqkv_t, bqkv, wout_t, bout,
                                                         num_heads=H, scale=SCALE)
    for fused_dw in (True, False):
        full = fb.attention_block_backward(x, qkv, attn, probs, lns, lnb, wqkv_t, wout_t, t(g),
                                           num_heads=H, scale=SCALE, fused_dw=fused_dw)
        needs = (True, False, False, False, False, False, False)
        only_x = fb.attention_block_backward(x, qkv, attn, probs, lns, lnb, wqkv_t, wout_t, t(g),
                                             num_heads=H, scale=SCALE, needs=needs,
                                             fused_dw=fused_dw)
        assert [v is None for v in only_x] == [False] + [True] * 6
        assert torch.equal(only_x[0], full[0])


def test_training_default_route_is_kernel_4(monkeypatch):
    """FusedAttentionBlockFn's backward never reaches the fused-dW kernel."""
    calls = []
    monkeypatch.setattr(fb, "attention_bwd_fused_dw", lambda *a, **k: calls.append("fused_dw"))
    real = fb.attention_bwd_saved_db
    monkeypatch.setattr(fb, "attention_bwd_saved_db",
                        lambda *a, **k: calls.append("saved_db") or real(*a, **k))
    args, g = _block_inputs(2, 5, seed=2)
    leaves = [t(a).requires_grad_(True) for a in
              (args[0], args[1], args[2], args[3].T.copy(), args[4], args[5].T.copy(), args[6])]
    fb.fused_attention(*leaves, num_heads=H, scale=SCALE).backward(t(g))
    assert calls == ["saved_db"]


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    z = lambda *shape: torch.zeros(*shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pa.attention_bwd_fused_dw(z(1, 3, 192), z(1, 1, 3, 16), z(1, 3, 64), z(1, 3, 64),
                                  z(192, 64), num_heads=1, scale=1.0)


def test_wrapper_counts_no_launch_on_the_cpu():
    before = pa.attention_bwd_fused_dw.launches
    qkv, probs, do, tt, w = _bf16_inputs(2, 5, seed=0)
    pa.attention_bwd_fused_dw(qkv, probs, do, tt, w, num_heads=H, scale=SCALE)
    assert pa.attention_bwd_fused_dw.launches == before


def test_plain_version_contracts_kernel_4s_plain_dqkv():
    """Kernel 8 on the card is kernel 4's backward, then two products of its
    dqkv: the plain versions say the same.  db equals kernel 4's db up to the
    f32 summation order; dt is kernel 4's dqkv times W in f32, rounded once,
    bit for bit."""
    qkv, probs, do, tt, w = _bf16_inputs(6, 11, seed=5)
    kw = dict(num_heads=H, scale=SCALE)
    dt, dw, db = pa.attention_bwd_fused_dw_plain(qkv, probs, do, tt, w, **kw)
    dqkv, db4 = pa.attention_bwd_saved_plain(qkv, probs, do, with_db=True, **kw)
    d = dqkv.reshape(-1, 3 * C).float()
    assert torch.equal(dt, (d @ w.float()).to(torch.bfloat16).reshape(dt.shape))
    np.testing.assert_allclose(n(db), n(db4), rtol=0, atol=1e-6 * np.abs(n(db4)).max())
    np.testing.assert_allclose(n(dw), n(d.t() @ tt.reshape(-1, C).float()), rtol=0, atol=0)


@pytest.mark.parametrize("slice_rows", [64, 128, 192])
def test_dw_summed_over_row_slices_in_order_matches_the_plain_version(slice_rows):
    """Kernel 8 cuts dW's K (the B*S rows of dqkv) into slices of a fixed
    number of rows, a multiple of the GEMM's 64-deep step, and adds the f32
    partials in slice order: up to the f32 summation order, that is the plain
    version's dqkv^T t, the last slice ragged or not."""
    qkv, probs, do, tt, w = _bf16_inputs(23, 11, seed=6)  # 253 rows
    kw = dict(num_heads=H, scale=SCALE)
    d = pa.attention_bwd_saved_plain(qkv, probs, do, with_db=False, **kw).reshape(-1, 3 * C)
    d, tm = d.float(), tt.reshape(-1, C).float()
    partials = [d[r:r + slice_rows].t() @ tm[r:r + slice_rows]
                for r in range(0, d.shape[0], slice_rows)]
    assert len(partials) == -(-d.shape[0] // slice_rows) > 1
    dw = partials[0]
    for p in partials[1:]:
        dw = dw + p
    want = pa.attention_bwd_fused_dw_plain(qkv, probs, do, tt, w, **kw)[1]
    np.testing.assert_allclose(n(dw), n(want), rtol=0, atol=1e-5 * np.abs(n(want)).max())


def test_dw_slices_fill_whole_rounds_of_the_card_at_the_flagship_shape():
    """At qkv (192, 129, 2304) the slices of DW_SLICE_ROWS rows are 11, and
    with the 18 x 4 output tiles of 128 x 192 they are 792 work units: six
    whole rounds of an H100's 132 SMs, each unit 36 steps of 64 rows."""
    assert pa.DW_SLICE_ROWS % 64 == 0
    slices = -(-(192 * 129) // pa.DW_SLICE_ROWS)
    tiles = (2304 // 128) * (768 // 192)
    assert (slices, slices * tiles, slices * tiles % 132) == (11, 792, 0)
    assert pa.DW_SLICE_ROWS // 64 == 36


# Small stand-ins of chip_smoke.FUSED_DW_EDGE_SHAPES: a tile of 16 keys, one
# key (no control: dS is exactly zero), 3 heads, a width of 5 heads (no
# multiple of the GEMM's 192 columns), a long ragged batch.
SMALL_FUSED_DW_EDGES = ((3, 16, 384), (4, 1, 384), (2, 40, 576), (3, 9, 960), (5, 33, 384))


def test_chip_smoke_fused_dw_phase_passes_on_the_plain_version(capsys):
    """Phase 18's kernel-8 checks rehearsed on the CPU, where the wrapper is
    its plain version: every edge is held, and at every shape with more than
    one key the misrounded control fails the rounding bound at this width."""
    import chip_smoke as cs

    errors = cs.phase_new_kernels(torch.device("cpu"), qkv_shapes=((4, 9, 384),),
                                  ablate_shapes=(), fused_dw_edges=SMALL_FUSED_DW_EDGES)
    assert errors == {"attention_bwd_fused_dw": 0.0, "fused_mlp_block_train": 0.0}
    out = capsys.readouterr().out
    for shape in ((4, 9, 384),) + SMALL_FUSED_DW_EDGES:
        line = next(x for x in out.splitlines()
                    if f"kernel 8 {shape} dt: control contracting" in x)
        assert line.endswith(f"held to it {shape[1] > 1}")
        assert f"kernel 8 {shape}: dt, dW and db bit-identical over two runs" in out
    assert set(cs.SAVED_EDGE_SHAPES) < set(cs.FUSED_DW_EDGE_SHAPES)
    assert (8, 129, 1536) in cs.FUSED_DW_EDGE_SHAPES


def test_chip_smoke_block_backward_phase_rehearses_on_the_cpu(capsys, monkeypatch):
    """Phase 19 on the plain versions: the kernel-8 route's seven grads
    against the kernel-4 route's, bqkv compared in its bits; the launch check
    only logs."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "REHEARSAL", True)
    launches = cs.phase_block_backward(torch.device("cpu"), shape=(4, 9, 128))
    assert launches == cs.launch_dict()
    out = capsys.readouterr().out
    assert "[block-bwd] grad bqkv: kernel-8 route bitwise equal to the kernel-4 route" in out
    for name in ("x", "ln_weight", "ln_bias", "wqkv", "bqkv", "wout", "bout"):
        assert f"[block-bwd] grad {name} " in out
