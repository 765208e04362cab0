"""The block kernels past the register tiles' 144 tokens, on the CPU.

Kernels 1, 3, 4 and 7 take heads of 64 over up to 256 tokens: the CLIP
flagship at MODEL.STRIDE_SIZE (12, 12) (211 tokens at 256x128) or at 384x128
(193).  On the CPU each wrapper, its wide form included, takes its plain
version; those are held here against the Pallas kernels they replace, run in
interpret mode as tests/test_torch_train_kernels.py runs them at S <= 144,
at S = 145, 193, 211 and 256 (heads of 64: width 128, two heads, batch 2),
then the tiny flagship at stride 12 against JAX's, and the wrappers' routing
by sequence length against a stand-in for the built library.
"""

import flax.linen
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.ops.fused_block import _fused_fwd_impl, _fused_infer_impl
from demo2_tpu.ops.packed_attention import _packed_bwd_saved_db
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.ops import fused_block as fb
from demo2_tpu_torch.ops import packed_attention as pa
from torch_port_helpers import (CPU, check_train_step, generator, jax_to_port_probs,
                                jax_train_case, load_port, n, port_to_jax_probs, t)

LONG_S = [145, 193, 211, 256]
B, C, H = 2, 128, 2  # two heads of 64
SCALE = 64 ** -0.5
# f32 on both sides; only the summation order differs (as at S <= 144).
TOL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES, CAMERA_NUM = 8, 3


def _attn_inputs(s, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    return (f(B, s, C), 1.0 + f(C, std=0.1), f(C, std=0.1), f(C, 3 * C, std=C ** -0.5),
            f(3 * C, std=0.1), f(C, C, std=C ** -0.5), f(C, std=0.1))


@pytest.mark.parametrize("s", LONG_S)
def test_block_forward_plain_matches_pallas_kernels(s):
    """Kernel 3's out, qkv, attn and probs (JAX's (H*B, S_pad, S_pad) moved
    to (B, H, S, S16)) against _fused_fwd_impl, kernel 1's out against
    _fused_infer_impl; the wide forms' wrappers are the same plain versions."""
    x, lns, lnb, wqkv, bqkv, wout, bout = _attn_inputs(s, seed=s)
    jargs = [jnp.asarray(a) for a in (x, lns, lnb, wqkv, bqkv, wout, bout)]
    out, qkv, attn, _, probs = _fused_fwd_impl(*jargs, H, SCALE, interpret=True)
    infer = _fused_infer_impl(*jargs, H, SCALE, interpret=True)
    args = (t(x), t(lns), t(lnb), t(wqkv.T.copy()), t(bqkv), t(wout.T.copy()), t(bout))
    kw = dict(num_heads=H, scale=SCALE)
    got = fb.fused_attention_block_train(*args, **kw)
    assert got[3].shape == pa.probs_shape(B, H, s)
    np.testing.assert_allclose(n(got[0]), np.asarray(out), **TOL)
    np.testing.assert_allclose(n(got[1]), np.asarray(qkv)[:, :s], **TOL)
    np.testing.assert_allclose(n(got[2]), np.asarray(attn)[:, :s], **TOL)
    np.testing.assert_allclose(n(got[3]), jax_to_port_probs(probs, B, H, s), **TOL)
    assert not n(got[3])[..., s:].any(), "probs columns past S must be zero"
    np.testing.assert_allclose(n(fb.fused_attention_block(*args, **kw)), np.asarray(infer),
                               **TOL)
    for a, w in zip(got, fb.fused_attention_block_train_wide(*args, **kw)):
        assert torch.equal(a, w)
    assert torch.equal(fb.fused_attention_block_wide(*args, **kw),
                       fb.fused_attention_block(*args, **kw))


def _saved_inputs(s, seed):
    """Packed qkv, saved probs (softmax rows, zero past S) and dO."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, s, 3 * C)).astype(np.float32)
    logits = rng.standard_normal((B, H, s, s)).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    probs = np.pad(p, ((0, 0), (0, 0), (0, 0), (0, pa.probs_cols(s) - s)))
    return qkv, probs.astype(np.float32), rng.standard_normal((B, s, C)).astype(np.float32)


def _pallas_saved_db(qkv, probs, do, dtype=jnp.float32):
    """_packed_bwd_saved_db in interpret mode on the padded inputs."""
    s = qkv.shape[1]
    s_pad = -(-s // 8) * 8
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, s_pad - s), (0, 0))), dtype)
    jprobs = jnp.asarray(port_to_jax_probs(probs, s_pad), dtype)
    dqkv, db = _packed_bwd_saved_db(H, SCALE, pad(qkv), jprobs, pad(do), interpret=True)
    return np.asarray(dqkv, np.float32), np.asarray(db)


@pytest.mark.parametrize("s", LONG_S)
def test_saved_probs_backward_plain_matches_pallas_kernel(s):
    """Kernel 4's dqkv and db against _packed_bwd_saved_db, and kernel 7's
    dqkv (the same arithmetic without db), both forms' wrappers."""
    qkv, probs, do = _saved_inputs(s, seed=s + 1)
    want, want_db = _pallas_saved_db(qkv, probs, do)
    assert not want[:, s:].any()  # the TPU's padded rows carry nothing
    kw = dict(num_heads=H, scale=SCALE)
    for fn_db, fn in ((pa.attention_bwd_saved_db, pa.attention_bwd_saved),
                      (pa.attention_bwd_saved_db_wide, pa.attention_bwd_saved_wide)):
        got, got_db = fn_db(t(qkv), t(probs), t(do), **kw)
        np.testing.assert_allclose(n(got), want[:, :s], **TOL)
        np.testing.assert_allclose(n(got_db), want_db, **TOL)
        assert torch.equal(fn(t(qkv), t(probs), t(do), **kw), got)


def test_saved_probs_backward_rounds_where_the_pallas_kernel_rounds_bf16():
    """At S = 211 in bf16, the plain version chip_smoke.py holds kernel 4's
    wide form to lies within ROUNDING_MEAN_TOL of the Pallas kernel on the
    same values, and its misrounded control (dS left in f32) beyond it."""
    import chip_smoke as cs

    s = 211
    qkv, probs, do = (t(a).to(torch.bfloat16) for a in _saved_inputs(s, seed=3))
    kw = dict(num_heads=H, scale=SCALE)
    want, want_db = _pallas_saved_db(n(qkv), n(probs), n(do), jnp.bfloat16)
    want = t(want[:, :s])
    got, got_db = pa.attention_bwd_saved_db_wide(qkv, probs, do, **kw)
    assert got.dtype == torch.bfloat16 and got_db.dtype == torch.float32
    assert cs.mean_err(got, want) <= cs.ROUNDING_MEAN_TOL
    np.testing.assert_allclose(n(got_db), want_db, rtol=0,
                               atol=cs.DB_REL * float(np.abs(want_db).max()))
    # The control is ~9e-5 away at these inputs: beyond the bound by a margin.
    assert cs.mean_err(cs._misrounded_saved_bwd(qkv, probs, do, **kw), want) > \
        5 * cs.ROUNDING_MEAN_TOL


# ---------------------------------------------------------------------------
# The wrappers' routing, against a stand-in for the built library
# ---------------------------------------------------------------------------


class _Lib:
    """The built library's limits: the register tiles, the block kernels'
    wide forms, the wide pair of kernels 5 and 6."""
    demo2_attention_head_dim = staticmethod(lambda: 64)
    demo2_attention_max_seq = staticmethod(lambda: 144)
    demo2_block_attention_max_seq = staticmethod(lambda: 256)
    demo2_packed_attention_wide_max_seq = staticmethod(lambda: 256)
    demo2_packed_attention_wide_takes_head = staticmethod(lambda d: int(d in (64, 96)))


class _Library:
    lib = _Lib()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, device="meta", dtype=dtype)


def _calls(s, heads):
    """The block wrappers of kernels 1, 3, 4 and 7 on meta tensors (not the
    CPU: each takes its kernel path) of sequence length s, width 768, and
    kernel 8's call."""
    c = 768
    x, qkv, do = (_meta(2, s, w) for w in (c, 3 * c, c))
    vec = lambda k: _meta(k, dtype=torch.float32)
    attn = dict(ln_weight=vec(c), ln_bias=vec(c), wqkv=_meta(3 * c, c), bqkv=vec(3 * c),
                wout=_meta(c, c), bout=vec(c))
    probs = _meta(*pa.probs_shape(2, heads, s))
    kw = dict(num_heads=heads, scale=SCALE)
    return {
        "fused_attention_block": lambda: fb.fused_attention_block(x, **attn, **kw),
        "fused_attention_block_train": lambda: fb.fused_attention_block_train(x, **attn, **kw),
        "attention_bwd_saved_db": lambda: pa.attention_bwd_saved_db(qkv, probs, do, **kw),
        "attention_bwd_saved": lambda: pa.attention_bwd_saved(qkv, probs, do, **kw),
    }, lambda: pa.attention_bwd_fused_dw(qkv, probs, do, _meta(2, s, c), _meta(3 * c, c), **kw)


class _Checked(Exception):
    """Kernel 8's inputs passed its wrapper's checks."""


@pytest.mark.parametrize("s,heads,route", [
    (129, 12, "regs"), (144, 12, "regs"),  # the register tiles
    (145, 12, "wide"), (193, 12, "wide"), (211, 12, "wide"), (256, 12, "wide"),
    (257, 12, None),                        # one token past the wide forms
    (211, 8, None), (129, 6, None),         # heads of 96 and of 128
])
def test_block_kernels_route_by_sequence_length(monkeypatch, s, heads, route):
    """Kernels 1, 3, 4 and 7 launch their register form at S <= 144 and their
    wide form at 145-256; kernel 8 takes both lengths (its C entry routes its
    first stage); past 256 tokens or at other heads each refuses, naming the
    ROADMAP item.  The launches are recorded, not made."""
    launched = []
    monkeypatch.setattr(pa, "kernel_library", lambda: _Library)
    for module in (pa, fb):
        monkeypatch.setattr(module, "_expect_cuda", lambda x, what: None)
    record = lambda wrapper, entry, *a, **k: launched.append((wrapper.__name__, entry))
    monkeypatch.setattr(fb, "_launch_attention", record)
    monkeypatch.setattr(pa, "_launch_saved_db", record)
    monkeypatch.setattr(pa, "_launch_saved", record)
    calls, fused_dw = _calls(s, heads)
    for name, call in calls.items():
        if route is None:
            with pytest.raises(NotImplementedError, match="ROADMAP.*wider heads, longer"):
                call()
        else:
            call()
            wrapper = name if route == "regs" else f"{name}_wide"
            assert launched.pop() == (wrapper, f"demo2_{wrapper}")
    assert not launched
    checked = pa._check_inputs

    def check_then_stop(*args):
        checked(*args)
        raise _Checked

    monkeypatch.setattr(pa, "_check_inputs", check_then_stop)
    with pytest.raises(NotImplementedError if route is None else _Checked):
        fused_dw()


# ---------------------------------------------------------------------------
# The tiny flagship at stride 12
# ---------------------------------------------------------------------------


@pytest.fixture
def no_flax_dropout(monkeypatch):
    """Dropout off on the JAX side (its draws are not the port's); the port
    gets a dropout rate of 0.  Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _stride12_cfg():
    """apply_tiny's depth and width (two blocks, width 64, two heads) at
    256x128 and MODEL.STRIDE_SIZE (12, 12): 211 tokens a block, the kernels'
    route on, f32."""
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.INPUT.SIZE_TRAIN = cfg.INPUT.SIZE_TEST = (256, 128)
    cfg.MODEL.STRIDE_SIZE = (12, 12)
    cfg.MODEL.SDTPS_CROSS_ATTN_TYPE = "attention"
    cfg.MODEL.SDTPS_SPARSE_RATIO = 0.7
    cfg.TPU.USE_FLASH_ATTENTION = True
    cfg.SOLVER.IMS_PER_BATCH = 8
    return cfg


def test_tiny_flagship_at_stride_12_matches_jax(no_flax_dropout):
    """The eval embedding, and one train step's loss, every gradient and the
    BatchNorm statistics (check_train_step), of the tiny flagship at 211
    tokens against JAX's, the weights carried over by the converter."""
    import jax

    cfg = _stride12_cfg()
    case = jax_train_case(cfg, NUM_CLASSES, CAMERA_NUM, batch=8)
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), case["variables"])
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    assert port.backbone.base.positional_embedding.shape[0] == 211
    from demo2_tpu.models import make_model as j_make_model

    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    images, cams = case["images"], case["cams"]
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        case["variables"], jnp.asarray(images), jnp.asarray(cams))
    with torch.no_grad():
        got = port(t(images), t(cams).long(), train=False)
    assert got["embedding"].shape == (8, port.embed_dim)
    np.testing.assert_allclose(n(got["embedding"]), np.asarray(want["embedding"]),
                               rtol=1e-4, atol=1e-5)
    # Over 211 tokens the f32 loss of either side lies ~3.5e-5 from an f64 run
    # of the port (4.485454: JAX 4.485492, the port 4.485422), so the two are
    # held to 2e-5 of each other rather than the helper's 1e-5.
    check_train_step(cfg, port, case, NUM_CLASSES, loss_rtol=2e-5)


def test_chip_smoke_long_phase_rehearses_on_the_plain_versions(monkeypatch, capsys):
    """Phase 36 (a) of chip_smoke.py on the CPU at small stand-ins, where each
    wrapper is its plain version: every check runs (the controls beyond
    their bounds), the launch checks only log, nothing is timed."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "REHEARSAL", True)
    errors, times = cs.phase_long_block_kernels(CPU, None, shapes=((2, 145, 128),),
                                                edges=((2, 150, 384),))
    assert errors == {name: 0.0 for name in ("fused_attention_block_wide",
                                             "fused_attention_block_train_wide",
                                             "attention_bwd_saved_db_wide",
                                             "attention_bwd_saved_wide")}
    assert times == {}
    out = capsys.readouterr().out
    assert "kernel 3 attn (2, 145, 128): vs the plain version rounding alike" in out
    assert "misrounded control" in out
    assert "kernel 4 dqkv (2, 150, 384): control with dS left in f32" in out
    assert "kernel 8 (2, 145, 384)" in out
