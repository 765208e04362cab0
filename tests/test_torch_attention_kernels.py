"""The port's packed and head-major attention against the JAX package.

On the CPU the wrappers of kernels 5 and 6 (ops/packed_attention.py) and 9
and 10 (ops/flash_attention.py) take their plain PyTorch versions.  Those are
held here against the Pallas kernels they replace: kernels 5 and 6 in
interpret mode, as tests/test_pallas_kernels.py runs them; kernels 9 and 10,
whose JAX entry has no interpret switch, against the TPU kernel's arithmetic
composed from JAX's own `_softmax_probs` (flash_attention.py:41-50) and
against `jax.vjp` of that composition.  The autograd Functions run the plain
versions inside the same autograd structure on the CPU as the kernels on the
card; their gradients are held against `jax.vjp` of the JAX entry points.
Then attention_core's and MultiHeadAttention's routes: the mask, dropout on
the probabilities, and the conditions under which implementation="pallas"
reaches a kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.ops import attention as jattn
from demo2_tpu.ops.flash_attention import _softmax_probs
from demo2_tpu.ops.flash_attention import flash_attention as j_flash_attention
from demo2_tpu.ops.packed_attention import _packed_bwd, _packed_fwd_impl
from demo2_tpu.ops.packed_attention import packed_self_attention as j_packed
from demo2_tpu_torch.ops import attention as attn
from demo2_tpu_torch.ops import flash_attention as fa
from demo2_tpu_torch.ops import packed_attention as pa
from torch_port_helpers import CPU, apply_jit, generator, load_port, n, random_variables, t

# f32 on both sides: only the summation order differs.
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 on both sides with the same rounding points: an f32 sum taken in
# another order can put a value on the other side of a bf16 rounding
# boundary, which moves it by one bf16 ulp (2^-8 relative), and that carries
# through the products after it.  Held to two ulps at unit scale.
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -6)

H, D = 2, 64


def _qkv(b, s, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, 3 * H * D)).astype(np.float32), \
        rng.standard_normal((b, s, H * D)).astype(np.float32)


def _jnp(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(a, dtype):
    return t(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# Kernels 5 and 6: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [9, 17])  # S_pad 16 and 24 on the TPU: padded keys and queries
def test_packed_forward_plain_matches_pallas_kernel(s, dtype):
    qkv, _ = _qkv(4, s, seed=s)
    scale = D ** -0.5
    want = _packed_fwd_impl(_jnp(qkv, dtype), H, scale, interpret=True)
    got = pa.packed_attention_fwd(_torch(qkv, dtype), num_heads=H, scale=scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == (4, s, H * D)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [9, 17])
def test_packed_backward_plain_matches_pallas_kernel(s, dtype):
    qkv, do = _qkv(4, s, seed=10 + s)
    scale = D ** -0.5
    (want,) = _packed_bwd(H, scale, _jnp(qkv, dtype), _jnp(do, dtype), interpret=True)
    got = pa.packed_attention_bwd(_torch(qkv, dtype), _torch(do, dtype), num_heads=H,
                                  scale=scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == qkv.shape
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


# The edges of the register-resident kernels' tiling, as packed qkv at a small
# width: no padded row, exactly one tile, one key, two and a half tiles, three
# heads.  (batch, S, heads).
PACKED_EDGES = [(2, 144, 2), (2, 16, 2), (3, 1, 2), (2, 40, 2), (2, 77, 3)]


def _packed_edge_inputs(edge, seed):
    b, s, heads = edge
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, 3 * heads * D)).astype(np.float32), \
        rng.standard_normal((b, s, heads * D)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", PACKED_EDGES)
def test_packed_forward_plain_matches_pallas_kernel_at_the_tiling_edges(edge, dtype):
    qkv, _ = _packed_edge_inputs(edge, seed=60 + edge[1])
    heads, scale = edge[2], D ** -0.5
    want = _packed_fwd_impl(_jnp(qkv, dtype), heads, scale, interpret=True)
    got = pa.packed_attention_fwd(_torch(qkv, dtype), num_heads=heads, scale=scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == (*edge[:2], heads * D)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", PACKED_EDGES)
def test_packed_backward_plain_matches_pallas_kernel_at_the_tiling_edges(edge, dtype):
    qkv, do = _packed_edge_inputs(edge, seed=70 + edge[1])
    heads, scale = edge[2], D ** -0.5
    (want,) = _packed_bwd(heads, scale, _jnp(qkv, dtype), _jnp(do, dtype), interpret=True)
    got = pa.packed_attention_bwd(_torch(qkv, dtype), _torch(do, dtype), num_heads=heads,
                                  scale=scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == qkv.shape
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


# The wide pair's shapes (csrc/packed_attention_wide.cu), at a small batch:
# vit_small's 8 heads of 96 at stride 16 (129 tokens) and 12 (211), and 12
# heads of 64 at 211 tokens; vit_small's scale is 768^-0.5.  Then the edges
# of its domain at batch 1: one key, one 16-row tile, the first S past the
# register pair's 144, and the longest S, with both head widths.  (batch, S,
# heads, head width, scale).
WIDE_CASES = [(2, 129, 8, 96, 768 ** -0.5), (2, 211, 8, 96, 768 ** -0.5),
              (2, 211, 12, 64, 64 ** -0.5),
              (1, 1, 12, 64, 64 ** -0.5), (1, 16, 8, 96, 768 ** -0.5),
              (1, 145, 12, 64, 64 ** -0.5), (1, 256, 8, 96, 768 ** -0.5)]


def _wide_inputs(case, seed):
    b, s, heads, d, _ = case
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, 3 * heads * d)).astype(np.float32), \
        rng.standard_normal((b, s, heads * d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: f"{c[1]}x{c[2]}x{c[3]}")
def test_wide_packed_forward_plain_matches_pallas_kernel(case, dtype):
    """The wide pair's forward (its plain version on the CPU) against the
    Pallas kernel in interpret mode, heads of 96 and S = 211."""
    qkv, _ = _wide_inputs(case, seed=80 + case[1])
    b, s, heads, d, scale = case
    want = _packed_fwd_impl(_jnp(qkv, dtype), heads, scale, interpret=True)
    got = pa.packed_attention_wide_fwd(_torch(qkv, dtype), num_heads=heads, scale=scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, heads * d)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: f"{c[1]}x{c[2]}x{c[3]}")
def test_wide_packed_backward_plain_matches_pallas_kernel(case, dtype):
    qkv, do = _wide_inputs(case, seed=90 + case[1])
    b, s, heads, d, scale = case
    (want,) = _packed_bwd(heads, scale, _jnp(qkv, dtype), _jnp(do, dtype), interpret=True)
    got = pa.packed_attention_wide_bwd(_torch(qkv, dtype), _torch(do, dtype), num_heads=heads,
                                       scale=scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == qkv.shape
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


def test_packed_function_grads_match_jax_vjp():
    """PackedSelfAttentionFn (kernels 5 and 6 on the card) against jax.vjp of
    packed_self_attention, which on the CPU is JAX's XLA path."""
    qkv, do = _qkv(3, 9, seed=3)
    scale = D ** -0.5
    want, vjp = jax.vjp(lambda x: j_packed(x, H, scale), jnp.asarray(qkv))
    (want_grad,) = vjp(jnp.asarray(do))
    x = t(qkv).requires_grad_(True)
    y = pa.packed_self_attention(x, H, scale)
    assert type(y.grad_fn).__name__ == "PackedSelfAttentionFnBackward"
    y.backward(t(do))
    np.testing.assert_allclose(n(y), np.asarray(want), **TOL)
    np.testing.assert_allclose(n(x.grad), np.asarray(want_grad), **GRAD_TOL)
    with torch.no_grad():  # no gradient wanted: the forward kernel alone
        assert pa.packed_self_attention(x, H, scale).grad_fn is None


# ---------------------------------------------------------------------------
# Kernels 9 and 10: plain versions against the TPU kernel's arithmetic
# ---------------------------------------------------------------------------


def _flash_kernel_math(q, k, v, scale):
    """flash_attention.py::_fwd_kernel per (sample, head), from JAX's own
    _softmax_probs: q, k, v cast to f32, p kept in f32 for the PV product,
    the output rounded to the input dtype.  (B, S, H, D) in and out."""
    s = q.shape[1]
    qt, kt, vt = (jnp.moveaxis(x, 1, 2).astype(jnp.float32) for x in (q, k, v))
    probs = jax.vmap(jax.vmap(lambda a, b: _softmax_probs(a, b, scale, s)))(qt, kt)
    return jnp.moveaxis(jnp.einsum("bhqk,bhkd->bhqd", probs, vt), 1, 2).astype(q.dtype)


def _bshd(b, s, seed, count):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, H, D)).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [9, 17])
def test_flash_forward_plain_matches_kernel_math(s, dtype):
    q, k, v = _bshd(3, s, seed=20 + s, count=3)
    scale = D ** -0.5
    want = _flash_kernel_math(*(_jnp(a, dtype) for a in (q, k, v)), scale)
    got = fa.flash_attention_fwd(*(_torch(a, dtype) for a in (q, k, v)), scale=scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [9, 17])
def test_flash_backward_plain_matches_vjp_of_kernel_math(s, dtype):
    """_bwd_kernel's f32 arithmetic is the derivative of _fwd_kernel's:
    kernel 10's plain version against jax.vjp of the composition, computed
    in f32 from the (rounded) inputs and rounded at the end, as the kernel
    rounds only its outputs."""
    q, k, v, do = _bshd(2, s, seed=30 + s, count=4)
    scale = D ** -0.5
    rounded = [np.asarray(_jnp(a, dtype), np.float32) for a in (q, k, v, do)]
    _, vjp = jax.vjp(lambda *a: _flash_kernel_math(*a, scale), *map(jnp.asarray, rounded[:3]))
    want = vjp(jnp.asarray(rounded[3]))
    got = fa.flash_attention_bwd(*(_torch(a, dtype) for a in (q, k, v, do)), scale=scale)
    tol = GRAD_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(n(g), np.asarray(_jnp(w, dtype), np.float32), err_msg=name,
                                   **tol)


# The edges of the register-resident kernels' tiling (one warp per 16 rows,
# nine tiles at most): no padded row, exactly one tile, one key, other head
# counts.  f32 on both sides: only the summation order differs.
EDGE_SHAPES = [(2, 144, 2, 64), (2, 16, 2, 64), (3, 1, 2, 64), (2, 77, 3, 64)]


def _edge_inputs(shape, seed, count):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_flash_forward_plain_matches_kernel_math_at_the_tiling_edges(shape):
    q, k, v = _edge_inputs(shape, seed=40 + shape[1], count=3)
    scale = shape[3] ** -0.5
    want = _flash_kernel_math(*map(jnp.asarray, (q, k, v)), scale)
    got = fa.flash_attention_fwd(t(q), t(k), t(v), scale=scale)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_flash_backward_plain_matches_vjp_of_kernel_math_at_the_tiling_edges(shape):
    q, k, v, do = _edge_inputs(shape, seed=50 + shape[1], count=4)
    scale = shape[3] ** -0.5
    _, vjp = jax.vjp(lambda *a: _flash_kernel_math(*a, scale), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = fa.flash_attention_bwd(t(q), t(k), t(v), t(do), scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == shape
        np.testing.assert_allclose(n(g), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_flash_function_grads_match_jax_vjp():
    q, k, v, do = _bshd(2, 9, seed=4, count=4)
    scale = D ** -0.5
    want, vjp = jax.vjp(lambda *a: j_flash_attention(*a, scale=scale),
                        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    y = fa.flash_attention(*leaves, scale=scale)
    assert type(y.grad_fn).__name__ == "FlashAttentionFnBackward"
    y.backward(t(do))
    np.testing.assert_allclose(n(y), np.asarray(want), **TOL)
    for name, leaf, w in zip("qkv", leaves, want_grads):
        np.testing.assert_allclose(n(leaf.grad), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_attention_wrappers_never_fall_back_off_the_cpu():
    qkv = torch.zeros(1, 3, 3 * H * D, device="meta", dtype=torch.bfloat16)
    do = torch.zeros(1, 3, H * D, device="meta", dtype=torch.bfloat16)
    q = torch.zeros(1, 3, H, D, device="meta", dtype=torch.bfloat16)
    calls = [lambda: pa.packed_attention_fwd(qkv, num_heads=H, scale=1.0),
             lambda: pa.packed_attention_bwd(qkv, do, num_heads=H, scale=1.0),
             lambda: fa.flash_attention_fwd(q, q, q, scale=1.0),
             lambda: fa.flash_attention_bwd(q, q, q, q, scale=1.0)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


FIRST_DESIGN_OF_5_AND_6 = ["packed_attention_fwd_first", "packed_attention_bwd_first",
                           "demo2_packed_attention_first", "demo2_packed_attention_bwd_first"]


@pytest.mark.parametrize("name", FIRST_DESIGN_OF_5_AND_6)
def test_first_design_of_kernels_5_and_6_is_gone(name):
    """Kernels 5 and 6 have one design: the wrappers and C entries that kept
    their first one callable for a timing are in no signature, source or
    module of the package."""
    import demo2_tpu_torch
    from demo2_tpu_torch.ops import kernel_lib
    from pathlib import Path

    assert not hasattr(pa, name) and name not in kernel_lib._SIGNATURES
    package = Path(demo2_tpu_torch.__file__).parent
    files = [p for p in package.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    assert files and not [p.name for p in files if name in p.read_text()]


def test_every_cuda_source_is_part_of_the_build():
    """kernel_lib hashes and compiles what SOURCES and HEADERS name: a file
    under csrc/ that neither names would change no build."""
    from demo2_tpu_torch.ops import kernel_lib

    on_disk = sorted(p.name for p in kernel_lib.CSRC_DIR.iterdir())
    assert on_disk == sorted(kernel_lib.SOURCES + kernel_lib.HEADERS)
    assert all(name.endswith(".cu") for name in kernel_lib.SOURCES)
    assert all(name.endswith(".cuh") for name in kernel_lib.HEADERS)
    for source, entries in (("flash_attention.cu", ("demo2_flash_attention",
                                                    "demo2_flash_attention_bwd")),
                            ("packed_attention.cu", ("demo2_packed_attention",
                                                     "demo2_packed_attention_bwd")),
                            ("attention_bwd.cu", ("demo2_attention_bwd_saved_db",
                                                  "demo2_attention_bwd_saved")),
                            ("attention_ablate.cu", ("demo2_attention_ablate",))):
        text = (kernel_lib.CSRC_DIR / source).read_text()
        for entry in entries:
            assert entry in kernel_lib._SIGNATURES
            assert f'extern "C" int {entry}(' in text
    # No first design is kept; every signature has its C entry.
    assert not [e for e in kernel_lib._SIGNATURES if "first" in e]
    sources = "".join((kernel_lib.CSRC_DIR / src).read_text() for src in kernel_lib.SOURCES)
    assert all(f" {entry}(" in sources for entry in kernel_lib._SIGNATURES)
    # The register-resident headers carry every attention kernel, the Hopper
    # GEMM the block kernels' products and kernel 8's; kernel 8 lives beside
    # kernels 4 and 7, whose instantiation it runs, and the first design's
    # header is gone.
    includes = {src: (kernel_lib.CSRC_DIR / src).read_text() for src in kernel_lib.SOURCES}
    for src in ("packed_attention.cu", "flash_attention.cu", "attention_bwd.cu"):
        assert '#include "attention_regs_bwd.cuh"' in includes[src]
    for src in ("attention_ablate.cu", "fused_attention_block.cu"):
        assert '#include "attention_regs_fwd.cuh"' in includes[src]
    for src in ("fused_attention_block.cu", "fused_mlp_block.cu", "attention_bwd.cu"):
        assert '#include "gemm_sm90.cuh"' in includes[src]
    assert 'extern "C" int demo2_attention_bwd_fused_dw(' in includes["attention_bwd.cu"]
    assert "attention_bwd.cuh" not in kernel_lib.HEADERS
    assert not (kernel_lib.CSRC_DIR / "attention_bwd.cuh").exists()
    assert not [src for src in on_disk if '#include "attention_bwd.cuh"' in
                (kernel_lib.CSRC_DIR / src).read_text()]


@pytest.mark.parametrize("width,heads,seq,ok", [
    (768, 12, 129, True),     # ViT-B: 12 heads of 64
    (768, 12, 144, True),     # the longest sequence the tiles hold
    (768, 8, 129, False),     # vit_small: heads of 96
    (776, 12, 129, False),    # a width that is no whole number of 64-wide heads
    (768, 12, 211, False),    # stride 12 at 256x128: 211 tokens
])
def test_attention_limits_raise_naming_the_roadmap(monkeypatch, width, heads, seq, ok):
    """Every attention wrapper checks the tiles' limits through one function,
    which reads them from the library: here a stand-in for the built one."""
    class Lib:
        demo2_attention_head_dim = staticmethod(lambda: 64)
        demo2_attention_max_seq = staticmethod(lambda: 144)

    class Library:
        lib = Lib()

    monkeypatch.setattr(pa, "kernel_library", lambda: Library)
    if ok:
        assert pa.check_head_limits("attention", width, heads, seq) is Library
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.*wider heads"):
            pa.check_head_limits("attention", width, heads, seq)


class _WideLib:
    """A stand-in for the built library's limits, both pairs of kernels 5
    and 6."""
    demo2_attention_head_dim = staticmethod(lambda: 64)
    demo2_attention_max_seq = staticmethod(lambda: 144)
    demo2_packed_attention_wide_max_seq = staticmethod(lambda: 256)
    demo2_packed_attention_wide_takes_head = staticmethod(lambda d: int(d in (64, 96)))


@pytest.mark.parametrize("width,heads,seq,ok,regs", [
    (768, 12, 129, True, True),    # ViT-B at stride 16: the register pair
    (768, 12, 144, True, True),
    (768, 8, 129, True, False),    # vit_small: heads of 96, the wide pair
    (768, 12, 211, True, False),   # stride 12 at 256x128: 211 tokens
    (768, 8, 256, True, False),    # the wide pair's longest
    (768, 8, 1, True, False),
    (768, 6, 129, False, False),   # heads of 128
    (768, 8, 257, False, False),   # one token past the wide pair
    (776, 8, 129, False, False),   # no whole number of heads
])
def test_packed_attention_limits_take_the_wide_pair(monkeypatch, width, heads, seq, ok, regs):
    """Kernels 5 and 6 take heads of 64 or 96 over at most 256 tokens; the
    register pair the (64, <= 144) shapes of them, the wide pair the rest.
    Beyond, the refusal names the ROADMAP item; the other attention kernels
    keep the register tiles' limits."""
    class Library:
        lib = _WideLib()

    monkeypatch.setattr(pa, "kernel_library", lambda: Library)
    if ok:
        assert pa.check_head_limits("attention", width, heads, seq, wide=True) is Library
        assert pa.regs_take(Library, width, heads, seq) == regs
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.*wider heads"):
            pa.check_head_limits("attention", width, heads, seq, wide=True)
    if not regs:
        with pytest.raises(NotImplementedError, match="ROADMAP.*wider heads"):
            pa.check_head_limits("attention", width, heads, seq)


def test_wide_pair_refuses_f32_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP.*f32 inputs"):
        pa.check_head_limits("attention", 768, 8, 211, torch.float32, wide=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_attention_kernels_on_other_dtypes_raise_naming_the_roadmap(dtype):
    """The Pallas kernels 5, 6, 9 and 10 run on f32 too; the CUDA tiles read
    bf16, so another dtype on the card raises naming the ROADMAP item (before
    the library is even asked for its limits)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.*f32 inputs"):
        pa.check_head_limits("attention", 768, 12, 129, dtype)


def _meta(*shape, dtype):
    return torch.zeros(*shape, device="meta", dtype=dtype)


def _block_kernel_calls(dtype):
    """Kernels 1, 2 (both forms), 3, 4, 7 and 8 on an x of `dtype` that lies on
    no CPU: each wrapper must refuse it by name before it looks further."""
    from demo2_tpu_torch.ops import fused_block as fb

    c, f = H * D, 4 * H * D
    x, qkv, do = (_meta(2, 9, w, dtype=dtype) for w in (c, 3 * c, c))
    vec = lambda n_: _meta(n_, dtype=torch.float32)
    attn = dict(ln_weight=vec(c), ln_bias=vec(c), wqkv=_meta(3 * c, c, dtype=dtype),
                bqkv=vec(3 * c), wout=_meta(c, c, dtype=dtype), bout=vec(c))
    mlp = dict(ln_weight=vec(c), ln_bias=vec(c), w1=_meta(f, c, dtype=dtype), b1=vec(f),
               w2=_meta(c, f, dtype=dtype), b2=vec(c))
    probs = _meta(*pa.probs_shape(2, H, 9), dtype=dtype)
    kw = dict(num_heads=H, scale=D ** -0.5)
    return {
        "fused_attention_block": lambda: fb.fused_attention_block(x, **attn, **kw),
        "fused_mlp_block": lambda: fb.fused_mlp_block(x, **mlp),
        "fused_mlp_block_train": lambda: fb.fused_mlp_block_train(x, **mlp),
        "fused_attention_block_train": lambda: fb.fused_attention_block_train(x, **attn, **kw),
        "attention_bwd_saved_db": lambda: pa.attention_bwd_saved_db(qkv, probs, do, **kw),
        "attention_bwd_saved": lambda: pa.attention_bwd_saved(qkv, probs, do, **kw),
        "attention_bwd_fused_dw": lambda: pa.attention_bwd_fused_dw(
            qkv, probs, do, _meta(2, 9, c, dtype=dtype), _meta(3 * c, c, dtype=dtype), **kw),
    }


@pytest.mark.parametrize("name", ["fused_attention_block", "fused_mlp_block",
                                  "fused_mlp_block_train", "fused_attention_block_train",
                                  "attention_bwd_saved_db", "attention_bwd_saved",
                                  "attention_bwd_fused_dw"])
def test_block_kernels_on_f32_raise_naming_the_roadmap(name, monkeypatch):
    """The Pallas kernels 1, 2, 3, 4, 7 and 8 compute in the dtype of x, f32
    included; the CUDA kernels read bf16.  An f32 model with the kernels on
    must be told so by name (ROADMAP queue 2a, item 1), not by a bare
    ValueError from a shape check, and before the library is built."""
    from demo2_tpu_torch.ops import fused_block as fb

    for module in (pa, fb):
        monkeypatch.setattr(module, "kernel_library",
                            lambda: pytest.fail("the library was asked for"))
        # The meta device stands in for the card: it is not the CPU, so each
        # wrapper takes its kernel path, and here it passes the device check.
        monkeypatch.setattr(module, "_expect_cuda", lambda x, what: None)
    with pytest.raises(NotImplementedError, match="ROADMAP.*f32 inputs in the block kernels"):
        _block_kernel_calls(torch.float32)[name]()


SMALL_ATTENTION_SHAPES = (((2, 9, 3 * H * D), (2, 9, H, D)), ((2, 17, 3 * H * D), (2, 17, H, D)))


@pytest.mark.parametrize("name", ["packed_attention_fwd", "packed_attention_bwd",
                                  "flash_attention_fwd", "flash_attention_bwd"])
def test_misrounded_controls_fail_the_rounding_bound(name):
    """chip_smoke.py holds kernels 5, 6, 9 and 10 within a mean of
    ROUNDING_MEAN_TOL of their plain versions.  Its controls, the same
    arithmetic rounded at a point where the Pallas kernel does not round,
    must be further than that from the plain version on every output, or the
    bound could not tell where a kernel rounds."""
    import chip_smoke as cs

    for packed_shape, flash_shape in SMALL_ATTENTION_SHAPES:
        _, plain, inputs, _, _ = cs.attention_kernel_cases(
            CPU, packed_shape, flash_shape, seed=3)[name]
        control = cs.misrounded_controls(H, D ** -0.5)[name]
        for yp, yw in zip(cs.as_tuple(plain(*inputs)), cs.as_tuple(control(*inputs))):
            assert yw.shape == yp.shape and yw.dtype == yp.dtype == torch.bfloat16
            assert cs.mean_err(yw, yp) > 10 * cs.ROUNDING_MEAN_TOL


def test_chip_smoke_attention_phase_passes_on_the_plain_versions():
    """Phase 9 of chip_smoke.py at small shapes on the CPU, where each wrapper
    is its plain version: every bound holds and every control fails."""
    import chip_smoke as cs

    errors = cs.phase_attention_kernels(CPU, shapes=SMALL_ATTENTION_SHAPES,
                                        flash_edges=EDGE_SHAPES)
    assert errors == {name: 0.0 for name in ("packed_attention_fwd", "packed_attention_bwd",
                                             "flash_attention_fwd", "flash_attention_bwd")}
    assert {s_[1] for s_ in cs.FLASH_EDGE_SHAPES} >= {144, 16, 1, 40, 77}
    assert any(s_[2] != 12 for s_ in cs.FLASH_EDGE_SHAPES)


def test_chip_smoke_attention_phase_checks_the_packed_kernels_at_the_edges(capsys):
    """Phase 9's edge shapes reach kernels 5 and 6 as packed qkv of the same
    sizes, and kernel 6's dqkv is compared over two runs at each of them."""
    import chip_smoke as cs

    edges = [(b, s, heads, D) for b, s, heads in PACKED_EDGES]
    cs.phase_attention_kernels(CPU, shapes=SMALL_ATTENTION_SHAPES[:1], flash_edges=edges)
    out = capsys.readouterr().out
    for b, s, heads in PACKED_EDGES:
        shape = (b, s, 3 * heads * D)
        assert f"packed_attention_fwd output 0 {shape}: vs plain" in out
        assert f"packed_attention_bwd output 0 {shape}: vs plain" in out
        assert f"packed_attention_bwd {shape}: every output bit-identical over two runs" in out
    assert [(b, s, 3 * h * d) for b, s, h, d in cs.FLASH_EDGE_SHAPES] == [
        (48, 144, 2304), (192, 16, 2304), (192, 1, 2304), (64, 40, 1152), (5, 77, 576)]


def test_chip_smoke_wide_attention_phase_passes_on_the_plain_versions(monkeypatch):
    """Phase 9's checks of the wide pair at small shapes (heads of 96 and of
    64) on the CPU: every bound holds, kernels 5's and 6's misrounded
    controls fail, the dispatch check runs (and only logs: plain versions
    count no launches); its shapes on the card are vit_small's and stride
    12's, and its edges S = 1, 16, 145 and 256."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "REHEARSAL", True)
    errors = cs.phase_wide_attention_kernels(CPU, shapes=((2, 21, 576, 2), (2, 17, 384, 2)),
                                             edges=((3, 1, 576, 2), (2, 33, 576, 2)))
    assert errors == {"packed_attention_wide_fwd": 0.0, "packed_attention_wide_bwd": 0.0}
    assert [(s_, c3 // 3 // h) for _, s_, c3, h in cs.WIDE_SHAPES] == [(211, 64), (211, 96),
                                                                       (129, 96)]
    assert {s_ for _, s_, _, _ in cs.WIDE_EDGE_SHAPES} >= {1, 16, 145, 256}
    assert cs.wide_scale(768, 8) == 768 ** -0.5 and cs.wide_scale(768, 12) == 0.125


REMOVED_DESIGNS = ["demo2_attention_bwd_saved_db_first", "attention_bwd_saved_db_first",
                   "time_designs", "attention_fwd_kernel", "launch_attention_fwd",
                   "gemm_bf16_kernel", "launch_gemm", "jaccard_min_sum_kernel",
                   "attention_bwd_head", "bwd_dq_tile", "kBwdSmemBytes",
                   "attention_bwd_fused_dw_kernel", "fused_dw_reduce_dt_kernel",
                   "fused_dw_reduce_groups_kernel", "dt_partial", "_dw_groups"]


@pytest.mark.parametrize("name", REMOVED_DESIGNS)
def test_removed_designs_are_gone(name):
    """Kernel 4's first design (its C entry, its wrapper and the timing that
    held it beside the kernel in use), the first attention forward of kernels
    1 and 3, the Ampere GEMM of the block kernels, kernel 12's dense
    register-tiled sum and kernel 8's first design (its shared-memory
    attention, its per-head dt partials, its per-group dW partials and the
    wrapper's grid of groups) have no trace left: no source of the package
    and nothing in chip_smoke.py names them."""
    import re
    from pathlib import Path

    import demo2_tpu_torch

    package = Path(demo2_tpu_torch.__file__).parent
    files = [p for p in package.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    files.append(package.parent / "chip_smoke.py")
    word = re.compile(rf"\b{name}\b")
    assert len(files) > 20 and not [p.name for p in files if word.search(p.read_text())]


BLOCK_EDGES = [(3, 9, 128), (1, 1, 128), (2, 5, 192)]


def test_chip_smoke_block_kernel_phase_rehearses_on_the_plain_versions(capsys, monkeypatch):
    """Phase 2 of chip_smoke.py, the block kernels at the edges of the GEMM's
    tiling, rehearsed on the CPU at small stand-ins, where each wrapper is its
    plain version: every kernel is held at every shape, kernel 3's out and
    attn and 2-train's out and h beside misrounded controls that fail their
    bound, and no time is read off the card."""
    import chip_smoke as cs

    def no_timing(*a, **k):
        raise AssertionError("the check phase read a time")

    monkeypatch.setattr(cs, "REHEARSAL", True)
    monkeypatch.setattr(cs, "cuda_ms", no_timing)
    assert cs.phase_kernels(CPU, shapes=BLOCK_EDGES) == {}  # errors: the flagship shape's
    out = capsys.readouterr().out
    for shape in BLOCK_EDGES:
        for name in ("fused_attention_block", "fused_mlp_block"):
            assert f"[kernel] {name} {shape}: vs plain bf16 max 0.000e+00" in out
        assert f"kernel 3 probs ({shape[0]}, {shape[2] // 64}, {shape[1]}, 16)" in out
        assert (f"kernel 3 out {shape}: vs the plain version rounding alike mean 0.000e+00"
                in out)
        assert f"kernel 2 (training form) {shape} out: vs the plain version rounding" in out
        assert f"kernel 2 (training form) {shape}: control with h rounded before the bias" in out
        assert f"[rehearsal] kernel 1 {shape}: bitwise equality to kernel 3" in out
    # out and attn of 3, out of 2-train: no attn control over one key
    assert out.count("; misrounded control") == 3 * len(BLOCK_EDGES) - 1
    assert cs.BLOCK_EDGE_SHAPES == ((3, 129, 768), (5, 77, 768), (1, 1, 768), (8, 129, 384),
                                    (8, 129, 512), (192, 129, 768), (192, 141, 768))


# ---------------------------------------------------------------------------
# attention_core and MultiHeadAttention: mask, dropout, routes
# ---------------------------------------------------------------------------


@pytest.fixture
def routes(monkeypatch):
    """Count the calls attention.py makes into the two kernel entries."""
    calls = {"flash": 0, "packed": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(attn, "flash_attention", counted("flash", fa.flash_attention))
    monkeypatch.setattr(attn, "packed_self_attention", counted("packed", pa.packed_self_attention))
    return calls


def _qkv_heads(sq, sk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 8)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("case", ["pallas", "pallas_with_mask", "pallas_unequal_lengths",
                                  "xla_with_mask"])
def test_attention_core_routes_and_matches_jax(case, routes):
    sk = 7 if case == "pallas_unequal_lengths" else 5
    q, k, v = _qkv_heads(5, sk, seed=6)
    mask = None
    if "mask" in case:
        mask = np.where(np.random.default_rng(7).random((2, 1, 5, sk)) < 0.3, -1e9,
                        0.0).astype(np.float32)
    impl = "xla" if case.startswith("xla") else "pallas"
    kw = dict(scale=8 ** -0.5, implementation=impl)
    want = jattn.attention_core(*map(jnp.asarray, (q, k, v)),
                                mask_bias=None if mask is None else jnp.asarray(mask), **kw)
    got = attn.attention_core(t(q), t(k), t(v), mask_bias=None if mask is None else t(mask), **kw)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    assert routes == {"flash": int(case == "pallas"), "packed": 0}


def test_attention_dropout_matches_jax_given_its_draw(routes):
    """Dropout on the probabilities: JAX's keep mask, drawn from its key, fed
    to the port; with dropout active the kernel route is not taken."""
    q, k, v = _qkv_heads(5, 5, seed=8)
    rate, rng = 0.3, jax.random.PRNGKey(5)
    want = jattn.attention_core(*map(jnp.asarray, (q, k, v)), scale=0.35, dropout_rate=rate,
                                deterministic=False, rng=rng, implementation="pallas")
    keep = jax.random.bernoulli(rng, 1.0 - rate, (2, 2, 5, 5))
    got = attn.plain_attention(t(q), t(k), t(v), scale=0.35, dropout_rate=rate,
                               keep=t(np.asarray(keep)))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    drawn = attn.attention_core(t(q), t(k), t(v), scale=0.35, dropout_rate=rate,
                                deterministic=False, generator=generator(1),
                                implementation="pallas")
    assert routes["flash"] == 0
    eval_out = attn.attention_core(t(q), t(k), t(v), scale=0.35, dropout_rate=rate,
                                   deterministic=True, implementation="pallas")
    assert routes["flash"] == 1 and not torch.allclose(drawn, eval_out)


@functools.cache
def _mha_pair(dropout_rate):
    jm = jattn.MultiHeadAttention(num_heads=2, dropout_rate=dropout_rate, implementation="pallas")
    x = np.zeros((2, 5, 16), np.float32)
    variables = random_variables(jm, x, seed=9)
    port = attn.MultiHeadAttention(16, 2, dtype=torch.float32, device=CPU, generator=generator(),
                                   dropout_rate=dropout_rate, implementation="pallas")
    return jm, variables, load_port(port, variables)


@pytest.mark.parametrize("case,want_routes", [
    ("self", {"packed": 1, "flash": 0}),
    ("cross_equal_lengths", {"packed": 0, "flash": 1}),
    ("cross_unequal_lengths", {"packed": 0, "flash": 0}),
    ("self_with_mask", {"packed": 0, "flash": 0}),
])
def test_multi_head_attention_routes_and_matches_jax(case, want_routes, routes):
    jm, variables, port = _mha_pair(0.0)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 7 if "unequal" in case else 5, 16)).astype(np.float32)
    mask = np.where(rng.random((2, 1, 5, 5)) < 0.3, -1e9, 0.0).astype(np.float32)
    args = (x,) if case.startswith("self") else (x, kv)
    mask_kw = {"mask_bias": mask} if "mask" in case else {}
    want = apply_jit(jm, variables, *map(jnp.asarray, args),
                     **{k: jnp.asarray(v) for k, v in mask_kw.items()})
    got = port(*map(t, args), **{k: t(v) for k, v in mask_kw.items()})
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
    assert routes == want_routes


def test_multi_head_attention_dropout_bypasses_the_kernels(routes):
    _, _, port = _mha_pair(0.2)
    x = t(np.random.default_rng(11).standard_normal((2, 5, 16)).astype(np.float32))
    port(x, train=True, generator=generator(2))
    assert routes == {"packed": 0, "flash": 0}
    port(x)  # eval: dropout off, the packed route
    assert routes == {"packed": 1, "flash": 0}
