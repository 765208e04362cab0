"""The block kernels past the wide forms' 256 tokens, on the CPU.

Kernels 1, 3, 4 and 7 take heads of 64 over up to 512 tokens in their long
forms: the CLIP flagship on TransReID's stride-12 crops, 384x128 (311 tokens)
and 256x256 (442).  On the CPU each wrapper, its long form included, takes
its plain version; those are held here against the Pallas kernels they
replace, run in interpret mode as tests/test_torch_block_long.py runs them at
145-256 tokens, at S = 257, 311, 442 and 512 (heads of 64: width 128, two
heads, batch 2), then the tiny flagship at 384x128 and stride 12 against
JAX's, and chip_smoke.py's phase 37 (a) rehearsed on the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.ops.fused_block import _fused_fwd_impl, _fused_infer_impl
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.ops import fused_block as fb
from demo2_tpu_torch.ops import packed_attention as pa
from demo2_tpu_torch.tools import wide_ablate
from test_torch_block_long import (B, C, CAMERA_NUM, H, NUM_CLASSES, SCALE, TOL, _attn_inputs,
                                   _pallas_saved_db, _saved_inputs, _stride12_cfg,
                                   no_flax_dropout)
from torch_port_helpers import (CPU, check_train_step, generator, jax_to_port_probs,
                                jax_train_case, load_port, n, t)

LONGER_S = [257, 311, 442, 512]


@pytest.mark.parametrize("s", LONGER_S)
def test_block_forward_plain_matches_pallas_kernels_past_256(s):
    """Kernel 3's out, qkv, attn and probs (JAX's (H*B, S_pad, S_pad) moved
    to (B, H, S, S16)) against _fused_fwd_impl, kernel 1's out against
    _fused_infer_impl, f32 on both sides (TOL: only the order of the sums
    differs); the long forms' wrappers are the same plain versions."""
    x, lns, lnb, wqkv, bqkv, wout, bout = _attn_inputs(s, seed=s)
    jargs = [jnp.asarray(a) for a in (x, lns, lnb, wqkv, bqkv, wout, bout)]
    out, qkv, attn, _, probs = _fused_fwd_impl(*jargs, H, SCALE, interpret=True)
    infer = _fused_infer_impl(*jargs, H, SCALE, interpret=True)
    args = (t(x), t(lns), t(lnb), t(wqkv.T.copy()), t(bqkv), t(wout.T.copy()), t(bout))
    kw = dict(num_heads=H, scale=SCALE)
    got = fb.fused_attention_block_train_long(*args, **kw)
    assert got[3].shape == pa.probs_shape(B, H, s)
    np.testing.assert_allclose(n(got[0]), np.asarray(out), **TOL)
    np.testing.assert_allclose(n(got[1]), np.asarray(qkv)[:, :s], **TOL)
    np.testing.assert_allclose(n(got[2]), np.asarray(attn)[:, :s], **TOL)
    np.testing.assert_allclose(n(got[3]), jax_to_port_probs(probs, B, H, s), **TOL)
    assert not n(got[3])[..., s:].any(), "probs columns past S must be zero"
    np.testing.assert_allclose(n(fb.fused_attention_block_long(*args, **kw)), np.asarray(infer),
                               **TOL)
    for a, w in zip(got, fb.fused_attention_block_train(*args, **kw)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("s", LONGER_S)
def test_saved_probs_backward_plain_matches_pallas_kernel_past_256(s):
    """Kernel 4's dqkv and db against _packed_bwd_saved_db (f32, TOL), and
    kernel 7's dqkv (the same arithmetic without db), the routed wrappers
    and the long forms' both."""
    qkv, probs, do = _saved_inputs(s, seed=s + 1)
    want, want_db = _pallas_saved_db(qkv, probs, do)
    assert not want[:, s:].any()  # the TPU's padded rows carry nothing
    kw = dict(num_heads=H, scale=SCALE)
    for fn_db, fn in ((pa.attention_bwd_saved_db, pa.attention_bwd_saved),
                      (pa.attention_bwd_saved_db_long, pa.attention_bwd_saved_long)):
        got, got_db = fn_db(t(qkv), t(probs), t(do), **kw)
        np.testing.assert_allclose(n(got), want[:, :s], **TOL)
        np.testing.assert_allclose(n(got_db), want_db, **TOL)
        assert torch.equal(fn(t(qkv), t(probs), t(do), **kw), got)


# ---------------------------------------------------------------------------
# The tiny flagship at 384x128, stride 12
# ---------------------------------------------------------------------------


def test_tiny_flagship_at_384x128_stride_12_matches_jax(no_flax_dropout):
    """The eval embedding, and one train step's loss, every gradient and the
    BatchNorm statistics (check_train_step), of the tiny flagship at 311
    tokens (31 x 10 patches + 1) against JAX's, the weights carried over by
    the converter, whose positional embedding follows the grid."""
    import jax

    from demo2_tpu.models import make_model as j_make_model

    cfg = _stride12_cfg()
    cfg.INPUT.SIZE_TRAIN = cfg.INPUT.SIZE_TEST = (384, 128)
    case = jax_train_case(cfg, NUM_CLASSES, CAMERA_NUM, batch=8)
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), case["variables"])
    for mlp in port.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    assert port.backbone.base.positional_embedding.shape[0] == 311
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    images, cams = case["images"], case["cams"]
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        case["variables"], jnp.asarray(images), jnp.asarray(cams))
    with torch.no_grad():
        got = port(t(images), t(cams).long(), train=False)
    assert got["embedding"].shape == (8, port.embed_dim)
    np.testing.assert_allclose(n(got["embedding"]), np.asarray(want["embedding"]),
                               rtol=1e-4, atol=1e-5)
    # Over 311 tokens, as over 211, the f32 sums of either side lie a few
    # 1e-5 from an f64 run: the losses are held to 2e-5 of each other.
    check_train_step(cfg, port, case, NUM_CLASSES, loss_rtol=2e-5)


def test_chip_smoke_longer_phase_rehearses_on_the_plain_versions(monkeypatch, capsys):
    """Phase 37 (a) of chip_smoke.py on the CPU at small stand-ins past 256
    tokens and at the edges of the 64-row tiling, where each wrapper is its
    plain version: every check runs (the controls beyond their bounds), the
    launch checks only log, nothing is timed."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "REHEARSAL", True)
    errors, times = cs.phase_long_block_kernels(
        CPU, None, shapes=((1, 257, 128), (1, 300, 128)), edges=((1, 272, 384), (1, 449, 384)),
        form="_long")
    assert errors == {name: 0.0 for name in cs.form_names("_long")}
    assert times == {}
    out = capsys.readouterr().out
    assert "kernel 3 attn (1, 257, 128): vs the plain version rounding alike" in out
    assert "misrounded control" in out
    assert "kernel 4 dqkv (1, 272, 384): control with dS left in f32" in out
    assert "kernel 8 (1, 257, 384)" in out
    # the forward's 64-row tiling's edges: a last query tile of a few rows;
    # 29 key tiles in the backward
    assert "kernel 3 attn (1, 300, 128): vs the plain version rounding alike" in out
    assert "kernel 4 dqkv (1, 449, 384): control with dS left in f32" in out
    assert "every launch on the long forms: ok" in out
    assert "attention_bwd_saved_db_long" in out  # the launches the card must show


# ---------------------------------------------------------------------------
# The tools: compare_trees' long-form cases, the long forms' ablations
# ---------------------------------------------------------------------------


def test_compare_trees_times_the_long_forms_by_name():
    """tools/compare_trees.py times, beside compare_cases, chip_smoke.py's
    longer_compare_cases: kernels 1, 3, 4 and 7 past 256 tokens, named
    "block S" (the wrappers that route by S; on the CPU their plain
    versions), so that `--cases "block 442"` and the ablation tool's --long
    run select them; each case's output bits have a digest."""
    import chip_smoke as cs
    from demo2_tpu_torch.tools import compare_trees

    cases = cs.longer_compare_cases(CPU, shapes=((1, 257, 128),))
    assert set(cases) == {f"{name} block 257" for name in (
        "fused_attention_block", "fused_attention_block_train", "attention_bwd_saved_db",
        "attention_bwd_saved")}
    assert "cs.longer_compare_cases(device)" in compare_trees.CHILD
    assert "NotImplementedError" in compare_trees.CHILD  # a parent that stops at 256 refuses
    for call in cases.values():
        outputs = cs.as_tuple(call())
        assert outputs[0].shape[:2] == (1, 257)
        assert cs.digest(call()) == cs.digest(outputs)  # the same bits, the same digest
    assert [s for _, s, _ in cs.LONGER_COMPARE_SHAPES] == [442, 311]
    assert wide_ablate.LONG_CASES == f"block {cs.LONGER_COMPARE_SHAPES[0][1]}"


@pytest.mark.parametrize("name", sorted(wide_ablate.LONG_ABLATIONS))
def test_every_long_ablation_applies_to_the_long_source(name):
    """Each of wide_ablate --long's text substitutions applies to
    csrc/attention_long_block.cuh as it stands."""
    source = wide_ablate.LONG_SOURCE.read_text()
    changed = wide_ablate.ablated(source, name, wide_ablate.LONG_ABLATIONS)
    assert changed != source
    for _, new in wide_ablate.LONG_ABLATIONS[name]:
        assert new in changed


def test_steps_option_times_the_442_token_flagship(monkeypatch):
    """tools/compare_trees.py --steps 442 hands the crop's tokens to each
    checkout's process, and chip_smoke.py::time_long_step rehearses the
    256x256 crop (its cache cut to LONGER_PIDS ids, as phase 37 cuts it) on
    the plain versions: one timed call of its step and request, their line."""
    import chip_smoke as cs
    from demo2_tpu_torch.tools import compare_trees

    assert compare_trees.parse(["--steps", "442", "a", "b"]) == (["--steps", "442"], ["a", "b"])
    assert compare_trees.parse(["--steps", "a"]) == (["--steps", "211"], ["a"])
    assert compare_trees.parse(["--yardstick", "a"]) == (["--yardstick"], ["a"])
    with pytest.raises(SystemExit, match="usage"):
        compare_trees.parse(["--steps", "442"])
    assert cs.STEP_CROPS[442] == (cs.LONGER_CROPS[0], cs.LONGER_PIDS)
    monkeypatch.setattr(cs, "REHEARSAL", True)
    line = cs.time_long_step(CPU, None, rounds=1, reps=1, warmup=0, tokens=442)
    assert line.startswith("s12-442 step ") and "batch-64 request" in line
    assert "device busy" not in line
