"""HDM, ATMoE and GeneralFusion (models/hdm_atmoe.py) against their flax
originals on the CPU, at width 128 (two heads of 64: HDM's token-init scale
and its per-head logit scale differ, as they do at every width but 64) and
ATMoE with HEAD 4.  Every flax leaf is a seeded random value, loaded into the
port through the converter; inputs are seeded numpy arrays given to both.
In training the dropout rate is 0 on both sides, so the BatchNorms' batch
statistics and running-statistic updates are what train mode changes.  HDM
is also held against seven explicit attentions over the concatenated
subsets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.models.hdm_atmoe import ATMoE as JATMoE
from demo2_tpu.models.hdm_atmoe import GeneralFusion as JGeneralFusion
from demo2_tpu.models.hdm_atmoe import HDM as JHDM
import demo2_tpu.models.hdm_atmoe as jhdm
from demo2_tpu_torch.models import hdm_atmoe as thdm
from demo2_tpu_torch.models.hdm_atmoe import ATMoE, GeneralFusion, HDM
from demo2_tpu_torch.utils.converters import convert_flax_variables
from torch_port_helpers import CPU, generator, load_port, n, random_variables, t

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -5)
C, B, N, HEAD = 128, 8, 6, 4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SUBSETS = ((0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2))  # R N T RN RT NT RNT


def _normal(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(seed=0):
    return _normal(3, B, N, C, seed=seed), _normal(3, B, C, seed=seed + 1)


def test_constants_are_the_jax_packages():
    for name in ("SET_MEMBERSHIP", "PAIR_SET", "PAIR_MOD", "MOD_SETS", "MM_TO_SET", "SET_TO_MM",
                 "MM_SET_IDS"):
        np.testing.assert_array_equal(getattr(thdm, name), getattr(jhdm, name), err_msg=name)
    assert thdm.CARD_GROUPS == jhdm.CARD_GROUPS and thdm.NUM_SETS == jhdm.NUM_SETS
    # The tables agree with each other: pair i of the set-major order is the
    # modality-major pair MM_TO_SET[i], of set PAIR_SET[i] and modality PAIR_MOD[i].
    mm_mod = np.repeat(np.arange(3), 4)
    np.testing.assert_array_equal(thdm.MM_SET_IDS[thdm.MM_TO_SET], thdm.PAIR_SET)
    np.testing.assert_array_equal(mm_mod[thdm.MM_TO_SET], thdm.PAIR_MOD)
    np.testing.assert_array_equal(thdm.MOD_SETS.reshape(-1), thdm.MM_SET_IDS)
    np.testing.assert_array_equal(thdm.SET_TO_MM[thdm.MM_TO_SET], np.arange(12))
    for s, members in enumerate(SUBSETS):
        assert tuple(np.flatnonzero(thdm.SET_MEMBERSHIP[s])) == members


def _apply(jmodule, variables, *args, train=False, **kwargs):
    if not train:
        return jax.jit(lambda v, *a: jmodule.apply(v, *a, **kwargs))(variables, *args), None
    out, upd = jax.jit(lambda v, *a: jmodule.apply(v, *a, mutable=["batch_stats"],
                                                   rngs={"dropout": jax.random.PRNGKey(0)},
                                                   **kwargs))(variables, *args)
    return out, upd.get("batch_stats")


def _check_stats(port, variables, updated, tol):
    """The port's BatchNorm buffers after a training forward against the
    JAX batch_stats it returned."""
    want = convert_flax_variables({"params": variables["params"], "batch_stats": updated}, port)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    sd = port.state_dict()
    for k in stats:
        assert not np.array_equal(n(sd[k]), n(convert_flax_variables(variables, port)[k])), k
        np.testing.assert_allclose(n(sd[k]), n(want[k]), err_msg=k, **tol)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hdm_matches_jax(dtype, train):
    jdt, tdt = DTYPES[dtype]
    p, g = _tokens(1)
    jm = JHDM(C, dropout=0.0, dtype=jdt)
    variables = random_variables(jm, p, g, seed=2)
    port = load_port(HDM(C, dropout=0.0, dtype=tdt, device=CPU, generator=generator()),
                     variables)
    want, _ = _apply(jm, variables, jnp.asarray(p, jdt), jnp.asarray(g, jdt),
                     deterministic=not train)
    got = port(t(p).to(tdt), t(g).to(tdt), train, generator())
    assert got.shape == (7, B, C) and got.dtype == tdt
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32),
                               **(TOL if dtype == "float32" else BF16_TOL))


def test_hdm_matches_explicit_subset_attention():
    """Each set's output is one attention of its learned query over the
    concatenated [global; patches] segments of its members (f64 here, from
    the port's own parameters), then the set's out-projection."""
    p, g = _tokens(3)
    port = HDM(C, dtype=torch.float32, device=CPU, generator=generator(4))
    with torch.no_grad():
        for prm in port.parameters():  # random biases too, not their zero init
            prm.add_(0.1 * torch.randn(prm.shape, generator=generator(5), dtype=prm.dtype))
    got = port(t(p), t(g))
    h, d = C // 64, 64
    segs = torch.cat([t(g)[:, :, None], t(p)], dim=2).double()
    w_in, b_in = port.in_proj_kernel.double(), port.in_proj_bias.double()
    for s, members in enumerate(SUBSETS):
        x = torch.cat([segs[i] for i in members], dim=1)  # (B, L, C)
        wq, wk, wv = w_in[s].split(C, dim=-1)
        bq, bk, bv = b_in[s].split(C)
        q = (port.set_tokens[s].double() @ wq + bq).reshape(h, d)
        k = (x @ wk + bk).reshape(B, -1, h, d)
        v = (x @ wv + bv).reshape(B, -1, h, d)
        probs = torch.softmax(torch.einsum("hd,blhd->bhl", q, k) * d ** -0.5, dim=-1)
        o = torch.einsum("bhl,blhd->bhd", probs, v).reshape(B, C)
        o = o @ port.out_proj_kernel[s].double() + port.out_proj_bias[s].double()
        np.testing.assert_allclose(n(got[s]), n(o), err_msg=f"set {s}", **TOL)


def test_hdm_dropout_draws_from_the_generator():
    p, g = _tokens(6)
    port = HDM(C, dropout=0.5, dtype=torch.float32, device=CPU, generator=generator())
    a = port(t(p), t(g), True, generator(1))
    np.testing.assert_array_equal(n(a), n(port(t(p), t(g), True, generator(1))))
    assert not np.allclose(n(a), n(port(t(p), t(g), True, generator(2))))
    assert not np.allclose(n(a), n(port(t(p), t(g))))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_atmoe_matches_jax(dtype, train):
    jdt, tdt = DTYPES[dtype]
    feats = _normal(7, B, C, seed=7)
    jm = JATMoE(C, head=HEAD, dtype=jdt)
    variables = random_variables(jm, feats, seed=8)
    port = load_port(ATMoE(C, head=HEAD, dtype=tdt, device=CPU, generator=generator()),
                     variables)
    want, stats = _apply(jm, variables, jnp.asarray(feats, jdt), train=train,
                         use_running_average=not train)
    got = port(t(feats).to(tdt), train)
    assert got.shape == (B, 7 * C) and got.dtype == tdt
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)
    if train:
        _check_stats(port, variables, stats, TOL if dtype == "float32" else BF16_TOL)


def test_atmoe_refuses_a_head_count_that_does_not_divide_the_width():
    with pytest.raises(ValueError, match="HEAD"):
        ATMoE(C, head=3, dtype=torch.float32, device=CPU, generator=generator())


@pytest.mark.parametrize("use_atm", [True, False], ids=["atm", "hdm_only"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_general_fusion_matches_jax(dtype, train, use_atm):
    jdt, tdt = DTYPES[dtype]
    p, g = _tokens(9)
    jm = JGeneralFusion(C, use_hdm=True, use_atm=use_atm, head=HEAD, dropout=0.0, dtype=jdt)
    variables = random_variables(jm, p, g, seed=10)
    port = load_port(GeneralFusion(C, use_atm=use_atm, head=HEAD, dropout=0.0, dtype=tdt,
                                   device=CPU, generator=generator()), variables)
    want, stats = _apply(jm, variables, jnp.asarray(p, jdt), jnp.asarray(g, jdt), train=train,
                         deterministic=not train, use_running_average=not train)
    got = port(t(p).to(tdt), t(g).to(tdt), train, generator())
    assert got.shape == (B, 7 * C)
    tol = TOL if dtype == "float32" else BF16_TOL
    if dtype == "bfloat16" and train and use_atm:
        # ATMoE's batch-statistics BatchNorms over 8 samples magnify HDM's
        # bf16 rounding, which the two round at other points: a handful of
        # elements land beyond the bf16 tolerance of each other.  So both
        # are held against the f32 forward of the same weights, the port no
        # further from it than the JAX package.
        ref, _ = _apply(JGeneralFusion(C, use_hdm=True, use_atm=True, head=HEAD, dropout=0.0),
                        variables, p, g, train=True, deterministic=False,
                        use_running_average=False)
        ref = np.asarray(ref)
        err, jerr = np.abs(n(got) - ref), np.abs(np.asarray(want, np.float32) - ref)
        assert err.mean() <= 1.25 * jerr.mean() and err.max() <= 2 * jerr.max()
        assert (np.abs(n(got) - np.asarray(want, np.float32))
                > tol["atol"] + tol["rtol"] * np.abs(np.asarray(want, np.float32))).mean() < 1e-2
    else:
        np.testing.assert_allclose(n(got), np.asarray(want, np.float32), **tol)
    if train and use_atm:
        _check_stats(port, variables, stats, tol)


def test_seeded_init_matches_flax_scales():
    """The port's seeded init draws each parameter at its flax initialiser's
    scale (the draws themselves differ)."""
    port = GeneralFusion(512, use_atm=True, head=HEAD, dtype=torch.float32, device=CPU,
                         generator=generator(11))
    jm = JGeneralFusion(512, use_hdm=True, use_atm=True, head=HEAD)
    p, g = np.zeros((3, 2, 4, 512), np.float32), np.zeros((3, 2, 512), np.float32)
    jvars = jm.init({"params": jax.random.PRNGKey(0)}, p, g)["params"]
    flat = {"hdm." + k: v for k, v in jvars["hdm"].items()}
    flat.update({"moe.expert_kernel": jvars["moe"]["expert_kernel"]})
    sd = port.state_dict()
    for k in ("hdm.set_tokens", "hdm.in_proj_kernel", "hdm.out_proj_kernel",
              "moe.expert_kernel"):
        want, got = np.asarray(flat[k]).std(), n(sd[k]).std()
        assert sd[k].shape == flat[k].shape, k
        np.testing.assert_allclose(got, want, rtol=0.05, err_msg=k)
