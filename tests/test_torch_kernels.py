"""The port's fused ViT sub-blocks against the Pallas kernels they replace.

On the CPU the wrappers take their plain PyTorch versions; those are held
here against the Pallas kernels themselves, run in interpret mode as
tests/test_pallas_kernels.py runs them, in f32.  The CUDA kernels are held
against the same plain versions on the card by chip_smoke.py.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.ops.fused_block import _fused_infer_impl, _fused_mlp_fwd_impl
from demo2_tpu_torch.ops import fused_block as fb
from demo2_tpu_torch.ops import kernel_lib
from torch_port_helpers import n, t


def _attn_inputs(b, s, c, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    return (f(b, s, c), 1.0 + f(c, std=0.1), f(c, std=0.1), f(c, 3 * c, std=c ** -0.5),
            f(3 * c, std=0.1), f(c, c, std=c ** -0.5), f(c, std=0.1))


def _mlp_inputs(b, s, c, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, std=1.0: (rng.standard_normal(shape) * std).astype(np.float32)
    return (f(b, s, c), 1.0 + f(c, std=0.1), f(c, std=0.1), f(c, 4 * c, std=c ** -0.5),
            f(4 * c, std=0.1), f(4 * c, c, std=(4 * c) ** -0.5), f(c, std=0.1))


# (b, s, c, heads): S=9 pads to 16 in the Pallas kernel, so its key masking
# is exercised; b=3 gives one sample per program; the last case is the
# flagship's head geometry (129 tokens, 12 heads of 64).
ATTN_CASES = [(3, 9, 32, 4), (4, 13, 64, 2), (1, 129, 768, 12)]


@pytest.mark.parametrize("b,s,c,h", ATTN_CASES)
def test_attention_block_plain_matches_pallas_kernel(b, s, c, h):
    x, lns, lnb, wqkv, bqkv, wout, bout = _attn_inputs(b, s, c, seed=b + s)
    scale = (c // h) ** -0.5
    want = _fused_infer_impl(*(jnp.asarray(a) for a in (x, lns, lnb, wqkv, bqkv, wout, bout)),
                             h, scale, interpret=True)
    # The port takes Linear-layout (out, in) weights: the flax kernels transposed.
    got = fb.fused_attention_block(t(x), t(lns), t(lnb), t(wqkv.T.copy()), t(bqkv),
                                   t(wout.T.copy()), t(bout), num_heads=h, scale=scale)
    # f32 on both sides; only the summation order differs.
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,s,c", [(3, 9, 32), (2, 129, 768)])
def test_mlp_block_plain_matches_pallas_kernel(b, s, c):
    x, lns, lnb, w1, b1, w2, b2 = _mlp_inputs(b, s, c, seed=b + s)
    want, _ = _fused_mlp_fwd_impl(*(jnp.asarray(a) for a in (x, lns, lnb, w1, b1, w2, b2)),
                                  block_rows=8, interpret=True)
    got = fb.fused_mlp_block(t(x), t(lns), t(lnb), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, lns, lnb, wqkv, bqkv, wout, bout = (t(a) for a in _attn_inputs(2, 5, 32, seed=0))
    before = (fb.fused_attention_block.launches, fb.fused_mlp_block.launches)
    got = fb.fused_attention_block(x, lns, lnb, wqkv.T, bqkv, wout.T, bout, num_heads=4,
                                   scale=8 ** -0.5)
    want = fb.attention_block_plain(x, lns, lnb, wqkv.T, bqkv, wout.T, bout, num_heads=4,
                                    scale=8 ** -0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    m = [t(a) for a in _mlp_inputs(2, 5, 32, seed=1)]
    torch.testing.assert_close(fb.fused_mlp_block(m[0], m[1], m[2], m[3].T, m[4], m[5].T, m[6]),
                               fb.mlp_block_plain(m[0], m[1], m[2], m[3].T, m[4], m[5].T, m[6]),
                               rtol=0, atol=0)
    assert (fb.fused_attention_block.launches, fb.fused_mlp_block.launches) == before


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """A tensor off the CPU goes to the kernel path, which refuses what it
    cannot launch instead of computing on the plain path."""
    x, lns, lnb, wqkv, bqkv, wout, bout = (t(a).to("meta") for a in _attn_inputs(1, 3, 32, 0))
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_attention_block(x, lns, lnb, wqkv, bqkv, wout, bout, num_heads=4, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_mlp_block(x, lns, lnb, wqkv, bqkv, wout, bout)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        assert kernel_lib.find_nvcc() == "/usr/local/cuda/bin/nvcc"
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernel_lib.find_nvcc()


_C_TYPES = {"const void*": "p", "void*": "p", "int": "i", "float": "f"}
_CTYPES = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}


def test_ctypes_signatures_match_the_c_entry_points():
    """Each C entry of csrc/ is bound with one ctypes argtype per parameter,
    of the right kind (a pointer passed as an int would be cut to 32 bits)."""
    src = "".join((kernel_lib.CSRC_DIR / s).read_text() for s in kernel_lib.SOURCES)
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src, flags=re.S))
    assert set(entries) == set(kernel_lib._SIGNATURES)
    for name, params in entries.items():
        kinds = [_C_TYPES[" ".join(p.split()[:-1])] for p in params.split(",") if p.strip()]
        assert kinds == [_CTYPES[a] for a in kernel_lib._SIGNATURES[name]], name
