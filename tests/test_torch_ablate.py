"""The port's attention ablation tool (kernel 13) against the JAX tool on the
CPU.

On the CPU `ablate_attention` takes its plain PyTorch version; that is held
here against the Pallas kernel that tools/bench_kernel_ablate.py::make_kernel
builds.  That file times its cases when it is imported, so it is not
imported: `make_kernel` is cut out of its source and run in a namespace
whose batch is 8, whose repeat count is 1 and whose `pl.pallas_call` runs in
interpret mode.  S = 136, C = 768, H = 12 and the 129 valid keys stay as the
tool hard-codes them.  bf16 on both sides.
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from demo2_tpu_torch.tools import bench_kernel_ablate as ab
from torch_port_helpers import n, t

TOOL = Path(__file__).resolve().parent.parent / "tools" / "bench_kernel_ablate.py"
B, S, C, H = 8, 136, 768, 12


@functools.cache
def _make_kernel():
    """tools/bench_kernel_ablate.py::make_kernel, its module constants set
    for a CPU run.  With REP = 1 the tool's chain returns [o, o, o]."""
    tree = ast.parse(TOOL.read_text())
    (node,) = [x for x in tree.body if isinstance(x, ast.FunctionDef) and x.name == "make_kernel"]
    shim = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                 BlockSpec=pl.BlockSpec)
    ns = dict(B=B, S=S, C=C, H=H, DT=jnp.bfloat16, REP=1, _NEG_INF=-1e30, jax=jax, jnp=jnp,
              pl=shim, pltpu=pltpu)
    exec(compile(ast.Module([node], type_ignores=[]), str(TOOL), "exec"), ns)
    return ns["make_kernel"]


@functools.cache
def _qkv():
    rng = np.random.default_rng(13)
    return t(rng.standard_normal((B, S, 3 * C)).astype(np.float32) * 0.5).to(torch.bfloat16)


def test_the_tools_cases_are_the_jax_tools_cases():
    source = TOOL.read_text()
    for mode, heads in ab.CASES:
        assert f'timeit("{mode} h={heads}", make_kernel("{mode}", {heads})' in source
    assert ab.SHAPE == (192, S, 3 * C) and f"kmask = key_ids < {ab.VALID_KEYS}" in source
    assert f"s * {ab.FULL_SCALE}" in source


@pytest.mark.parametrize("mode,heads", ab.CASES, ids=[f"{m}_h{h}" for m, h in ab.CASES])
def test_plain_version_matches_the_tools_pallas_kernel(mode, heads):
    qkv = _qkv()
    want = np.asarray(_make_kernel()(mode, heads)(jnp.asarray(n(qkv), jnp.bfloat16)), np.float32)
    got = n(ab.ablate_attention(qkv, mode, heads))
    assert got.shape == (B, S, C)
    cols = heads * ab.HEAD_DIM  # the Pallas kernel leaves the other columns unwritten
    want = want[..., :cols]
    # Rounded once to bf16 on both sides from f32 sums taken in another order:
    # two bf16 ulps of the value, and of the output's typical size where a sum
    # cancels.
    tol = 2.0 ** -7 * (np.abs(want) + np.abs(want).mean())
    assert (np.abs(got[..., :cols] - want) <= tol).all()
    assert np.abs(want).mean() > 1e-3
    assert not got[..., cols:].any(), "the columns of the heads left out are zero"


def test_cases_leave_out_what_they_say():
    """Each case differs from the next, and `full` masks the keys >= 129."""
    qkv = _qkv()[:2]
    outs = {m: ab.ablate_attention(qkv, m, 12).float() for m in ab.MODES}
    for a in ab.MODES:
        for b in ab.MODES:
            assert a == b or not torch.allclose(outs[a], outs[b], atol=1e-2)
    moved = qkv.clone()
    moved[:, ab.VALID_KEYS:, C:] = 3.0  # the masked keys' k and v
    again = ab.ablate_attention(moved, "full", 12).float()
    assert torch.equal(again, outs["full"])
    assert not torch.equal(ab.ablate_attention(moved, "no_softmax", 12).float(),
                           outs["no_softmax"])


def test_slice_only_adds_in_the_compute_dtype():
    qkv = _qkv()[:1]
    q, k, v = qkv.split(C, dim=-1)
    assert torch.equal(ab.ablate_attention(qkv, "slice_only", 12), (q + k) + v)


def test_bad_cases_raise():
    qkv = _qkv()[:1]
    with pytest.raises(ValueError, match="mode"):
        ab.ablate_attention(qkv, "half", 12)
    with pytest.raises(ValueError, match="heads"):
        ab.ablate_attention(qkv, "full", 13)
    with pytest.raises(ValueError, match="scores_only"):
        ab.ablate_attention(qkv[:, :32], "scores_only", 12)


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    with pytest.raises(ValueError, match="CUDA"):
        ab.ablate_attention(torch.zeros(1, S, 3 * C, device="meta"), "full", 12)


def test_wrapper_counts_no_launch_on_the_cpu():
    before = ab.ablate_attention.launches
    ab.ablate_attention(_qkv()[:1], "full", 4)
    assert ab.ablate_attention.launches == before


def test_bound_counts_the_bytes_of_the_written_columns():
    assert ab.case_bytes(ab.SHAPE, 12) == 2 * 192 * 136 * (2304 + 768)
    assert ab.case_bytes(ab.SHAPE, 4) == 2 * 192 * 136 * (2304 + 256)


def test_compare_trees_refuses_what_it_cannot_time(tmp_path):
    """tools/compare_trees.py times checkouts in turns on the card: without
    arguments, with a directory that is no checkout, or without a card (each
    tree's process says so) it exits with a message and prints no time."""
    from demo2_tpu_torch.tools import compare_trees

    with pytest.raises(SystemExit, match="usage"):
        compare_trees.main([])
    with pytest.raises(SystemExit, match="holds no chip_smoke.py"):
        compare_trees.main([str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            compare_trees.main([str(Path(ab.__file__).resolve().parents[2])])


def test_compare_trees_times_every_redesigned_kernel():
    """tools/compare_trees.py times, in every checkout, the cases of
    chip_smoke.py's own compare_cases: the block kernels 1, 2, 2-train and 3,
    the attention kernels 5, 6, 9 and 10, kernel 12, the saved-probs
    backwards 8, 4 and 7, the wide pair of 5 and 6 (one case a shape,
    named by S and the head width) and kernels 1, 3, 4 and 7 past 144 tokens
    (named "block S", so that `--cases "block 211"` and the ablation tool's
    block run select them), each by the wrapper that counts its launches: on
    the CPU its plain version."""
    import chip_smoke as cs
    from demo2_tpu_torch.tools import compare_trees, wide_ablate

    cases = cs.compare_cases(torch.device("cpu"), block_shape=(2, 9, 128),
                             packed_shape=(2, 9, 384), flash_shape=(2, 9, 2, 64),
                             jaccard_size=(12, 60), qkv_shape=(2, 9, 384),
                             wide_shapes=((2, 21, 576, 2), (1, 17, 384, 2)),
                             long_shape=(1, 145, 128))
    assert set(cases) == {"fused_attention_block", "fused_mlp_block",
                          "fused_attention_block_train", "fused_mlp_block_train",
                          "packed_attention_fwd", "packed_attention_bwd",
                          "flash_attention_fwd", "flash_attention_bwd", "jaccard_min_sum",
                          "attention_bwd_fused_dw", "attention_bwd_saved_db",
                          "attention_bwd_saved",
                          "packed_attention_wide_fwd 21x96", "packed_attention_wide_bwd 21x96",
                          "packed_attention_wide_fwd 17x64", "packed_attention_wide_bwd 17x64",
                          "fused_attention_block block 145",
                          "fused_attention_block_train block 145",
                          "attention_bwd_saved_db block 145", "attention_bwd_saved block 145"}
    assert {name.split()[0] for name in cases} <= set(cs.all_kernels())
    assert "cs.compare_cases(device)" in compare_trees.CHILD
    assert compare_trees.CHIP_SMOKE == Path(cs.__file__).resolve()
    for name, call in cases.items():
        outputs = cs.as_tuple(call())
        assert all(torch.isfinite(y).all() for y in outputs)
        if name.endswith(" block 145"):
            assert outputs[0].shape[:2] == (1, 145)
    assert wide_ablate.BLOCK_CASES == f"block {cs.LONG_SHAPE[1]}"
