"""The port's metric-learning losses (demo2_tpu_torch/losses/
metric_learning.py) against the JAX package's on the CPU: every function's
outputs and its input gradients, on inputs made by numpy from a seed, f32 on
both sides (TOL: only the summation order differs).  The circle logits'
scale s = 256 multiplies a cosine's rounding (an ulp of 1, 1.2e-7) by up to
s * (1 + m) = 320, so their absolute tolerance is CIRCLE_ATOL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.losses import losses as jl
from demo2_tpu.losses import metric_learning as jml
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.losses import metric_learning as tml
from torch_port_helpers import n, t

TOL = dict(rtol=1e-5, atol=1e-6)
CIRCLE_ATOL = 4e-5
P, K, D, C = 4, 4, 32, 12
N = P * K


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    labels = np.repeat(np.arange(P), K)
    return dict(feat=f(N, D), feat2=f(N, D), feat3=f(N, D), weight=f(C, D),
                small=f(N, D, scale=0.3), labels=labels,
                head_labels=rng.integers(0, C, N), other_labels=np.roll(labels, 3) % (P - 1))


# name: (positional inputs, keyword arguments, indices of the differentiated inputs)
CASES = {
    "arcface": ("arcface_logits", ("weight", "feat", "head_labels"), {}, (0, 1)),
    "arcface_easy": ("arcface_logits", ("weight", "feat", "head_labels"),
                     dict(easy_margin=True), (0, 1)),
    "arcface_ls": ("arcface_logits", ("weight", "feat", "head_labels"), dict(ls_eps=0.1), (0, 1)),
    "cosface": ("cosface_logits", ("weight", "feat", "head_labels"), {}, (0, 1)),
    "am_softmax": ("am_softmax_logits", ("weight", "feat", "head_labels"), dict(m=0.35), (0, 1)),
    "circle": ("circle_logits", ("weight", "feat", "head_labels"), {}, (0, 1)),
    "contrastive": ("contrastive_loss", ("small", "labels"), dict(margin=0.3), (0,)),
    "cluster": ("cluster_loss", ("feat", K), dict(margin=10.0), (0,)),
    "range": ("range_loss", ("feat", K), {}, (0,)),
    "range_top3": ("range_loss", ("feat", K), dict(top_k=3, margin=40.0), (0,)),
    "hetero_l2": ("hetero_loss", ("feat", "feat2", K), dict(dist_type="l2"), (0, 1)),
    "hetero_l1": ("hetero_loss", ("feat", "feat2", K), dict(dist_type="l1"), (0, 1)),
    "hetero_cos": ("hetero_loss", ("feat", "feat2", K), dict(dist_type="cos"), (0, 1)),
    "margin_l2": ("multimodal_margin_loss", ("feat", "feat2", "feat3", K),
                  dict(dist_type="l2", margin=60.0), (0, 1, 2)),
    "margin_l1": ("multimodal_margin_loss", ("feat", "feat2", "feat3", K),
                  dict(dist_type="l1"), (0, 1, 2)),
    "supcon": ("supcon_loss", ("small", "feat2", "labels", "labels"), {}, (0, 1)),
    # a row with no positive adds 0 (the reference's 0 / 0)
    "supcon_no_positive": ("supcon_loss", ("small", "feat2", "labels", "other_labels"),
                           dict(temperature=0.5), (0, 1)),
}


def _args(names, inputs, to):
    return [to(inputs[a]) if isinstance(a, str) else a for a in names]


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_learning_matches_jax(case):
    """Outputs (every element of a tuple) and the gradients of a seeded
    random projection of the first output with respect to the inputs."""
    name, names, kw, diff = CASES[case]
    tol = dict(TOL, atol=CIRCLE_ATOL) if name == "circle_logits" else TOL
    inputs = _inputs()
    jargs = _args(names, inputs, lambda a: jnp.asarray(a, jnp.int32 if a.dtype.kind == "i"
                                                       else jnp.float32))
    targs = _args(names, inputs, lambda a: torch.from_numpy(np.asarray(a)).clone())
    want = getattr(jml, name)(*jargs, **kw)
    cot = np.random.default_rng(1).standard_normal(np.shape(_first(want))).astype(np.float32)

    def j_scalar(*d):
        a = list(jargs)
        for i, x in zip(diff, d):
            a[i] = x
        return jnp.sum(_first(getattr(jml, name)(*a, **kw)) * cot)

    j_grads = jax.grad(j_scalar, argnums=tuple(range(len(diff))))(*[jargs[i] for i in diff])
    for i in diff:
        targs[i].requires_grad_()
    got = getattr(tml, name)(*targs, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(n(g), np.asarray(w), **tol)
    t_grads = torch.autograd.grad((_first(got) * t(cot)).sum(), [targs[i] for i in diff])
    for i, g, w in zip(diff, t_grads, j_grads):
        assert np.abs(np.asarray(w)).max() > 0, (case, i)
        np.testing.assert_allclose(n(g), np.asarray(w), err_msg=f"input {i}", **tol)


def test_euclidean_dist_is_the_pairwise_distance_of_both_packages():
    """losses.euclidean_dist delegates to metric_learning._pairwise_dist in
    both packages: one definition of the clamp and the sqrt, batched."""
    inputs = _inputs(3)
    x, y = inputs["feat"], inputs["feat2"]
    np.testing.assert_array_equal(n(tl.euclidean_dist(t(x), t(y))),
                                  n(tml._pairwise_dist(t(x), t(y))))
    np.testing.assert_allclose(n(tl.euclidean_dist(t(x), t(y))),
                               np.asarray(jl.euclidean_dist(jnp.asarray(x), jnp.asarray(y))),
                               **TOL)
    # batched over P groups (not a group against itself: self-distances are
    # the clamp's sqrt of a cancellation, round-off in both packages)
    g, h = x.reshape(P, K, D), y.reshape(P, K, D)
    np.testing.assert_allclose(n(tml._pairwise_dist(t(g), t(h))),
                               np.asarray(jml._pairwise_dist(jnp.asarray(g), jnp.asarray(h))),
                               **TOL)
    assert tml._pk_view(t(x), K).shape == (P, K, D)
    with pytest.raises(AssertionError, match="not divisible"):
        tml._pk_view(t(x), 5)


@pytest.mark.parametrize("fn", ["hetero_loss", "multimodal_margin_loss"])
def test_unknown_dist_type_raises_as_jax_does(fn):
    feats = [t(_inputs()["feat"])] * (2 if fn == "hetero_loss" else 3)
    jfeats = [jnp.asarray(_inputs()["feat"])] * len(feats)
    with pytest.raises(ValueError, match="unknown dist_type"):
        getattr(jml, fn)(*jfeats, K, dist_type="l3")
    with pytest.raises(ValueError, match="unknown dist_type"):
        getattr(tml, fn)(*feats, K, dist_type="l3")
