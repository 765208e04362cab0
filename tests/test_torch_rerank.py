"""The port's re-ranked evaluation against the JAX package on the CPU.

On the CPU the wrapper of kernel 12 takes its plain PyTorch version, the
blocked broadcast-min-sum; that is held here against a direct numpy double
loop and against the fori_loop branch of re_ranking_device, which is the one
JAX reaches on the CPU.  The kernel's bits are the ascending-k f32 sum,
`jaccard_min_sum_ordered`, held against a numpy float32 loop and against a
numpy model of the kernel's sum over the non-zeros.  re_ranking, the evaluator with re-ranking and with
the MSVR310 scene protocol, save_rank_list and run_eval / do_inference are
each held against their JAX counterparts on inputs made by numpy from a seed.
"""

import logging
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.engine.eval import build_eval_step as j_build_eval_step
from demo2_tpu.engine.eval import run_eval as j_run_eval
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.utils.metrics import R1mAPEvaluator as JEvaluator
from demo2_tpu.utils.reranking import re_ranking_device
from demo2_tpu.visualize.rank_list import save_rank_list as j_save_rank_list
from demo2_tpu_torch.data import device_cache as dc
from demo2_tpu_torch.data.datasets import SyntheticTriModal
from demo2_tpu_torch.engine.eval import do_inference, run_eval
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.utils import reranking as rr
from demo2_tpu_torch.utils.metrics import R1mAPEvaluator
from demo2_tpu_torch.visualize.rank_list import save_rank_list
from torch_port_helpers import CPU, generator, load_port, n, random_variables, t


def _clustered(nq, ng, dim=24, ids=9, seed=0, duplicates=True):
    """Unit features around `ids` centres, (nq + ng, dim), with their ids;
    with `duplicates`, a few gallery rows repeat other rows exactly (ties)."""
    rng = np.random.default_rng(seed)
    total = nq + ng
    centres = rng.standard_normal((ids, dim))
    pids = np.arange(total) % ids
    f = centres[pids] + 0.35 * rng.standard_normal((total, dim))
    if duplicates:
        f[nq + 3] = f[nq + 11]
        f[nq + 5] = f[1]  # a gallery copy of a query
        f[total - 1] = f[total - 2]
    f = (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)
    return f, pids.astype(np.int64)


# ---------------------------------------------------------------------------
# Kernel 12's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,ng,depth", [(7, 13, 29), (70, 333, 333), (65, 257, 40)])
def test_min_sum_plain_matches_a_numpy_double_loop(nq, ng, depth):
    rng = np.random.default_rng(nq)
    vq = rng.standard_normal((nq, depth)).astype(np.float32)
    vg = rng.standard_normal((ng, depth)).astype(np.float32)
    want = np.empty((nq, ng), np.float64)
    for i in range(nq):
        for j in range(ng):
            want[i, j] = np.minimum(vq[i], vg[j]).astype(np.float64).sum()
    got = rr.jaccard_min_sum(t(vq), t(vg))
    assert got.shape == (nq, ng) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)  # f32 sums of `depth` terms


def _fori_loop_case(nq, ng):
    """re_ranking_device's result at lambda 0 (1 - m / (2 - m) of its
    blocked min-sum m alone) and the port's V of the same features."""
    f, _ = _clustered(nq, ng, seed=3)
    want = np.asarray(re_ranking_device(jnp.asarray(f[:nq]), jnp.asarray(f[nq:]), 8, 3, 0.0))
    v, _ = rr.reciprocal_weights(t(f[:nq]), t(f[nq:]), 8, 3)
    return want, v


@pytest.mark.parametrize("nq,ng", [(23, 74), (64, 256)], ids=["ragged", "whole_tiles"])
def test_min_sum_plain_matches_the_fori_loop_branch_of_jax(nq, ng):
    """The port's V through the plain min-sum must give re_ranking_device's
    result at lambda 0."""
    want, v = _fori_loop_case(nq, ng)
    m = rr.jaccard_min_sum_plain(v[:nq].contiguous(), v)
    assert m.min() >= 0 and m.max() <= 1 + 1e-6  # rows of V sum to 1
    np.testing.assert_allclose(n(1.0 - m / (2.0 - m))[:, nq:], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nq,ng", [(23, 74), (64, 256)], ids=["ragged", "whole_tiles"])
def test_min_sum_ordered_matches_the_fori_loop_branch_of_jax(nq, ng):
    """The kernel's bits, the ascending sum, give re_ranking_device's result
    at lambda 0 within the plain version's 1e-6."""
    want, v = _fori_loop_case(nq, ng)
    m = rr.jaccard_min_sum_ordered(v[:nq].contiguous(), v)
    assert m.min() >= 0 and m.max() <= 1 + 1e-6
    np.testing.assert_allclose(n(1.0 - m / (2.0 - m))[:, nq:], want, rtol=0, atol=1e-6)


def _ascending_f32(vq, vg):
    """The min-sum as a numpy float32 loop: one add per k, ascending, from +0.0."""
    acc = np.zeros((vq.shape[0], vg.shape[0]), np.float32)
    for k in range(vq.shape[1]):
        acc = acc + np.minimum(vq[:, k, None], vg[None, :, k])
    return acc


def _over_nonzeros(vq, vg):
    """Kernel 12's sum: ascending k from +0.0, adding only where both
    operands are non-zero (numpy float32)."""
    acc = np.zeros((vq.shape[0], vg.shape[0]), np.float32)
    for k in range(vq.shape[1]):
        a, b = vq[:, k, None], vg[None, :, k]
        acc = np.where((a != 0) & (b != 0), acc + np.minimum(a, b), acc)
    return acc


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("nq,ng,depth", [(7, 13, 29), (70, 333, 333), (65, 257, 40)])
def test_min_sum_ordered_is_the_float32_ascending_loop_bit_for_bit(nq, ng, depth):
    rng = np.random.default_rng(depth)
    vq = rng.standard_normal((nq, depth)).astype(np.float32)
    vg = rng.standard_normal((ng, depth)).astype(np.float32)
    got = rr.jaccard_min_sum_ordered(t(vq), t(vg))
    assert got.shape == (nq, ng) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(n(got)), _bits(_ascending_f32(vq, vg)))


def _nonnegative_weights(case):
    """Vq, Vg (numpy f32): re-ranking weights of clustered features at k2 =
    15 or 1, or rows that are all zero, all non-zero or 5% non-zero."""
    if case.startswith("k2="):
        f, _ = _clustered(23, 74, seed=8)
        v, _ = rr.reciprocal_weights(t(f[:23]), t(f[23:]), 20, int(case[3:]))
        return n(v[:23]), n(v)
    rng = np.random.default_rng(2)

    def rows(count, depth=301):
        kind = np.arange(count)[:, None] % 3  # full, 5%, zero
        v = rng.random((count, depth)) + 1e-3
        v = v * ((kind == 0) | ((kind == 1) & (rng.random((count, depth)) < 0.05)))
        return (v / np.maximum(v.sum(1, keepdims=True), 1e-12)).astype(np.float32)

    return rows(17), rows(40)


@pytest.mark.parametrize("case", ["k2=15", "k2=1", "zero_and_full_rows"])
def test_sum_over_the_nonzeros_has_the_bits_of_the_dense_ascending_sum(case):
    """For non-negative inputs every skipped term is a zero, and a zero added
    to an f32 partial sum that starts at +0.0 changes no bit: the kernel's
    sum over the non-zeros equals the dense ascending sum bit for bit, where
    the descending sum does not."""
    vq, vg = _nonnegative_weights(case)
    assert (vq >= 0).all() and (vg >= 0).all() and 0 < (vg != 0).mean() < 1
    if case == "zero_and_full_rows":
        assert not vq[2].any() and vq[0].all() and vg[3].all() and not vg[5].any()
    want = n(rr.jaccard_min_sum_ordered(t(vq), t(vg)))
    np.testing.assert_array_equal(_bits(_over_nonzeros(vq, vg)), _bits(want))
    descending = _ascending_f32(vq[:, ::-1], vg[:, ::-1])
    assert not np.array_equal(_bits(descending), _bits(want))


def test_min_sum_never_falls_back_off_the_cpu_and_counts_no_cpu_launch():
    v = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rr.jaccard_min_sum(v, v)
    before = rr.jaccard_min_sum.launches
    rr.jaccard_min_sum(torch.rand(3, 5), torch.rand(4, 5))
    assert rr.jaccard_min_sum.launches == before


# ---------------------------------------------------------------------------
# re_ranking against re_ranking_device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,ng", [(23, 74), (16, 112)], ids=["ragged", "even"])
@pytest.mark.parametrize("k1,k2", [(8, 3), (5, 1), (50, 15)])
def test_re_ranking_matches_jax(k1, k2, nq, ng):
    f, _ = _clustered(nq, ng, seed=k1 + nq)
    want = np.asarray(re_ranking_device(jnp.asarray(f[:nq]), jnp.asarray(f[nq:]), k1, k2, 0.3))
    got = n(rr.re_ranking(t(f[:nq]), t(f[nq:]), k1, k2, 0.3))
    assert got.shape == (nq, ng)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    top = lambda d: np.argsort(d, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(top(got), top(want))


def test_rank_positions_break_ties_by_index_as_jax_does():
    d = t(np.asarray([[0.0, 0.5, 0.0, 0.5, 0.25], [1.0, 1.0, 1.0, 0.0, 0.0]], np.float32))
    np.testing.assert_array_equal(n(rr._rank_positions(d)), [[0, 3, 1, 4, 2], [2, 3, 4, 0, 1]])


def test_half_k1_rounds_half_to_even():
    """k1 = 5: numpy rounds 2.5 to 2, so the half-k sets take ranks <= 2;
    rounding up would differ from JAX on these features."""
    f, _ = _clustered(12, 40, seed=21)
    want = np.asarray(re_ranking_device(jnp.asarray(f[:12]), jnp.asarray(f[12:]), 5, 2, 0.3))
    np.testing.assert_allclose(n(rr.re_ranking(t(f[:12]), t(f[12:]), 5, 2, 0.3)), want,
                               rtol=0, atol=1e-5)


def test_k1_of_256_raises_as_in_jax():
    f, _ = _clustered(4, 12, seed=1)
    with pytest.raises(ValueError, match="k1=256"):
        rr.re_ranking(t(f[:4]), t(f[4:]), k1=256)
    with pytest.raises(ValueError, match="k1=256"):
        re_ranking_device(jnp.asarray(f[:4]), jnp.asarray(f[4:]), 256, 15, 0.3)


def test_full_f32_matmul_restores_the_callers_setting():
    previous = torch.backends.cuda.matmul.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = setting
            with rr.full_f32_matmul():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


# ---------------------------------------------------------------------------
# The evaluator and the rank list
# ---------------------------------------------------------------------------


def _eval_case(seed=5, nq=30, ng=90):
    f, pids = _clustered(nq, ng, seed=seed, ids=12)
    rng = np.random.default_rng(seed + 1)
    cams = rng.integers(0, 4, nq + ng).astype(np.int64)
    scenes = rng.integers(0, 3, nq + ng).astype(np.int64)
    f = f * rng.uniform(0.5, 2.0, (nq + ng, 1)).astype(np.float32)
    # The duplicates stay bit-identical rows, so that normalising them gives
    # exact ties in both frameworks (broken by index) and no near-ties that
    # rounding noise would order.
    f[nq + 3], f[nq + 5], f[-1] = f[nq + 11], f[1], f[-2]
    return f, pids, cams, scenes


def _both_evaluators(nq, **kw):
    return JEvaluator(num_query=nq, **kw), R1mAPEvaluator(num_query=nq, device=CPU, **kw)


@pytest.mark.parametrize("feat_norm", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("scene", [False, True], ids=["camera", "scene"])
@pytest.mark.parametrize("rerank", [False, True], ids=["euclid", "rerank"])
def test_evaluator_matches_jax(rerank, scene, feat_norm):
    f, pids, cams, scenes = _eval_case()
    nq = 30
    jev, ev = _both_evaluators(nq, reranking=rerank, scene_protocol=scene, feat_norm=feat_norm)
    for lo, hi in ((0, 50), (50, 120)):  # two updates, as batches arrive
        for e in (jev, ev):
            e.update(f[lo:hi], pids[lo:hi], cams[lo:hi], scenes[lo:hi] if scene else None)
    want_cmc, want_map = jev.compute(on_device=False)
    cmc, m_ap = ev.compute()
    assert cmc.shape == want_cmc.shape == (50,)
    np.testing.assert_allclose(cmc, want_cmc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(m_ap, want_map, rtol=0, atol=1e-6)
    assert 0.0 < m_ap < 1.0  # a case that can tell rankings apart


def test_scene_protocol_differs_from_the_camera_protocol_and_needs_scene_ids():
    f, pids, cams, scenes = _eval_case()
    results = []
    for scene in (False, True):
        ev = R1mAPEvaluator(num_query=30, device=CPU, scene_protocol=scene)
        ev.update(f, pids, cams, scenes)
        results.append(ev.compute()[1])
    assert results[0] != results[1]
    ev = R1mAPEvaluator(num_query=30, device=CPU, scene_protocol=True)
    ev.update(f, pids, cams)
    with pytest.raises(ValueError, match="sceneid"):
        ev.compute()


def test_broken_split_is_refused_before_the_distance_pass(monkeypatch):
    f, pids, cams, _ = _eval_case()
    pids = pids.copy()
    pids[:30] += 100  # no query identity in the gallery
    monkeypatch.setattr(rr, "re_ranking", lambda *a, **k: pytest.fail("re-ranked a broken split"))
    ev = R1mAPEvaluator(num_query=30, device=CPU, reranking=True)
    ev.update(f, pids, cams)
    with pytest.raises(AssertionError, match="do not appear in gallery"):
        ev.compute()


@pytest.mark.parametrize("scene", [False, True], ids=["camera", "scene"])
def test_rank_list_file_is_byte_identical_to_jax(scene, tmp_path):
    f, pids, cams, scenes = _eval_case(seed=7, nq=12, ng=70)
    nq = 12
    dist = n(rr.re_ranking(t(f[:nq]), t(f[nq:]), 8, 3))
    args = (dist, pids[:nq], pids[nq:], cams[:nq], cams[nq:]) + (
        (scenes[:nq], scenes[nq:]) if scene else (None, None))
    want = j_save_rank_list(*args, path=str(tmp_path / "jax.txt"), max_rank=20)
    got = save_rank_list(*args, path=str(tmp_path / "port.txt"), max_rank=20)
    assert got == str(tmp_path / "port.txt")
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    lines = data.decode().splitlines()
    assert lines[0] == "rank list file" and len(lines) == 1 + 2 * nq
    assert lines[1] == f"{pids[0]}_s{scenes[0] if scene else 0}_v{cams[0]}:"


def test_evaluator_writes_the_rank_list_jax_writes(tmp_path):
    f, pids, cams, scenes = _eval_case()
    jev, ev = _both_evaluators(30, reranking=True, scene_protocol=True)
    for e in (jev, ev):
        e.update(f, pids, cams, scenes)
    jev.compute(on_device=False, rank_list_path=str(tmp_path / "jax.txt"))
    ev.compute(rank_list_path=str(tmp_path / "port.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


# ---------------------------------------------------------------------------
# run_eval / do_inference against JAX's run_eval on the same weights
# ---------------------------------------------------------------------------

NUM_CLASSES, CAMERA_NUM = 10, 4


def _eval_cfg(dataset="MSVR310", rerank="yes", on_device=True):
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.DATASETS.NAMES = dataset
    cfg.TEST.RE_RANKING = rerank
    cfg.TEST.IMS_PER_BATCH = 32
    cfg.TPU.EVAL_ON_DEVICE = on_device
    return cfg.freeze()


class _ArrayPipe:
    """What demo2_tpu's run_eval reads of a data pipe, over arrays in memory."""

    def __init__(self, images, samples, batch_size):
        self.images, self.samples, self.batch_size = images, samples, batch_size

    def iter_batches(self, order, drop_last=True, pad_last=False):
        col = lambda rows, i: np.asarray([self.samples[r][i] for r in rows], np.int32)
        for start in range(0, len(order), self.batch_size):
            rows = list(order[start:start + self.batch_size])
            valid = len(rows)
            rows += [rows[-1]] * (self.batch_size - valid if pad_last else 0)
            yield types.SimpleNamespace(images=self.images[rows], pids=col(rows, 1),
                                        camids=col(rows, 2), viewids=col(rows, 3), valid=valid)


@pytest.fixture(scope="module")
def eval_setup():
    """A synthetic val set (20 queries, 60 gallery), the JAX model with random
    variables and the port's model carrying the same variables."""
    cfg = _eval_cfg()
    ds = SyntheticTriModal(num_pids=NUM_CLASSES, num_cams=CAMERA_NUM, imgs_per_pid=6,
                           image_size=tuple(cfg.INPUT.SIZE_TEST), seed=4, hard=True)
    samples = ds.query + ds.gallery
    u8 = ds.render_all(samples)
    cache = dc.DeviceCache.from_arrays(u8, samples, train=False, cfg=cfg, device=CPU)
    images = n(dc.normalize_batch(t(u8), cache.mean, cache.std))
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    cams = np.asarray([s[2] for s in samples[:2]], np.int32)
    variables = random_variables(jmodel, images[:2], cams, train=False, seed=4)
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator()),
                     variables)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    pipe = _ArrayPipe(images, samples, cfg.TEST.IMS_PER_BATCH)
    return ds, cache, jmodel, state, pipe, port


@pytest.mark.parametrize("dataset,rerank", [("MSVR310", "yes"), ("MSVR310", "no"),
                                            ("RGBNT201", "yes")])
def test_run_eval_matches_jax(eval_setup, dataset, rerank, tmp_path):
    ds, cache, jmodel, state, pipe, port = eval_setup
    cfg = _eval_cfg(dataset, rerank)
    nq = len(ds.query)
    jpath, ppath = str(tmp_path / "jax.txt"), str(tmp_path / "port.txt")
    want_cmc, want_map = j_run_eval(cfg, j_build_eval_step(cfg, jmodel), state, pipe, nq,
                                    rank_list_path=jpath)
    cmc, m_ap = run_eval(cfg, port, cache, nq, rank_list_path=ppath)
    np.testing.assert_allclose(cmc, want_cmc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(m_ap, want_map, rtol=0, atol=1e-6)
    assert 0.0 < m_ap <= 1.0
    # The rank lists: the same queries in the same order with the same
    # gallery entries removed; the ranking itself agrees at the head (f32
    # noise between the frameworks may swap near-ties further down).
    want_lines = open(jpath).read().splitlines()
    lines = open(ppath).read().splitlines()
    assert lines[0::2] == want_lines[0::2] and len(lines) == 1 + 2 * nq
    for got_row, want_row in zip(lines[2::2], want_lines[2::2]):
        assert sorted(got_row.split()) == sorted(want_row.split())
        assert got_row.split()[:3] == want_row.split()[:3]
    if dataset == "MSVR310":
        assert "_s1_" in "".join(lines[1::2])  # scene ids from the cache's viewids


def test_msvr310_writes_re_txt_by_default_and_others_write_nothing(eval_setup, tmp_path,
                                                                    monkeypatch):
    ds, cache, _, _, _, port = eval_setup
    monkeypatch.chdir(tmp_path)
    run_eval(_eval_cfg("RGBNT201", "no"), port, cache, len(ds.query))
    assert list(tmp_path.iterdir()) == []
    run_eval(_eval_cfg("MSVR310", "no"), port, cache, len(ds.query))
    assert [p.name for p in tmp_path.iterdir()] == ["re.txt"]
    assert (tmp_path / "re.txt").read_text().startswith("rank list file\n")


def test_do_inference_logs_the_reference_lines_and_ranks_off_device(eval_setup, tmp_path,
                                                                    caplog):
    ds, cache, _, _, _, port = eval_setup
    nq = len(ds.query)
    on = run_eval(_eval_cfg(), port, cache, nq, rank_list_path=str(tmp_path / "a.txt"))
    with caplog.at_level(logging.INFO, logger="DeMo"):
        cmc, m_ap = do_inference(_eval_cfg(on_device=False), port, cache, nq,
                                 rank_list_path=str(tmp_path / "b.txt"))
    np.testing.assert_array_equal(cmc, on[0])
    assert m_ap == on[1]
    messages = [r.getMessage() for r in caplog.records]
    assert messages == ["Validation Results", f"mAP: {m_ap * 100:.1f}%"] + [
        f"CMC curve, Rank-{r}: {cmc[r - 1] * 100:.1f}%" for r in (1, 5, 10)]


def test_do_train_evaluates_with_re_ranking(eval_setup, monkeypatch):
    """do_train's periodic eval takes TEST.RE_RANKING through run_eval."""
    from demo2_tpu_torch.data.sampler import RandomIdentitySampler
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import do_train

    ds, val, _, _, _, _ = eval_setup
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.TEST.RE_RANKING = "yes"
    cfg.TEST.IMS_PER_BATCH = 32
    cfg.SOLVER.MAX_EPOCHS = 1
    cfg.SOLVER.EVAL_PERIOD = 1
    cfg.freeze()
    train = dc.DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True, cfg=cfg,
                                       device=CPU)
    sampler = RandomIdentitySampler(ds.train, cfg.SOLVER.IMS_PER_BATCH,
                                    cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED)
    model = make_model(cfg, ds.num_train_pids, ds.num_train_cams, device=CPU,
                       generator=generator(0))
    calls = []
    real = rr.re_ranking
    monkeypatch.setattr(rr, "re_ranking", lambda *a, **k: calls.append(k) or real(*a, **k))
    state = create_train_state(cfg, model, len(sampler) // cfg.SOLVER.IMS_PER_BATCH)
    state, best = do_train(cfg, state, train, sampler, val, len(ds.query))
    assert calls == [dict(k1=50, k2=15, lambda_value=0.3)]
    assert 0.0 < state.history[-1]["mAP"] <= 1.0 and best["mAP"] == state.history[-1]["mAP"]


# ---------------------------------------------------------------------------
# chip_smoke.py's checks of kernel 12 and of the re-ranked eval, rehearsed on the CPU
# ---------------------------------------------------------------------------


# Small stand-ins of chip_smoke.JACCARD_EDGES: one query row over several
# gallery rows, one gallery row, depth 7, depth that is no multiple of 4.
SMALL_JACCARD_EDGES = ((1, 1, 7), (1, 97, 301), (37, 1, 333), (5, 60, 130))


def test_chip_smoke_jaccard_phase_passes_on_the_plain_version():
    import chip_smoke as cs

    assert cs.phase_jaccard_kernel(CPU, sizes=((40, 120), (7, 90)),
                                   edges=SMALL_JACCARD_EDGES) == {"jaccard_min_sum": 0.0}
    vq, v = cs.rerank_weights(12, 60, CPU)
    assert vq.shape == (12, 72) and v.shape == (72, 72)
    np.testing.assert_allclose(n(v.sum(1)), 1.0, atol=1e-5)


def test_chip_smoke_jaccard_phase_rehearses_its_bitwise_checks(capsys):
    """The jaccard phase on a numpy model of kernel 12 (the sum over the
    non-zeros): every density and edge is bitwise equal to the ascending sum,
    the descending-k control fails at each, the negative inputs are computed;
    the plain version, which sums in another order, fails the bitwise
    check."""
    import chip_smoke as cs

    def kernel_model(vq, vg):
        return t(_over_nonzeros(n(vq), n(vg)))

    cs.phase_jaccard_kernel(CPU, sizes=((40, 120),), edges=SMALL_JACCARD_EDGES,
                            min_sum=kernel_model)
    out = capsys.readouterr().out
    for what in ("40 x 160 k2=15", "40 x 160 k2=1", "40 x 160 uniform") + tuple(
            f"edge {a} x {b} x {c}" for a, b, c in SMALL_JACCARD_EDGES):
        line = next(x for x in out.splitlines() if f"kernel 12 {what}:" in x)
        assert "bitwise equal to the ascending sum True (the descending-k control False" in line
    assert "uniform: Vq (40, 160) (100.00% non-zero)" in out
    assert out.count("with negative values in V") == 2
    with pytest.raises(RuntimeError, match="differ in their bits"):
        cs.phase_jaccard_kernel(CPU, sizes=((40, 120),), edges=(),
                                min_sum=rr.jaccard_min_sum_plain)


def test_chip_smoke_rerank_eval_phase_runs_on_the_cpu(monkeypatch):
    """Phase 16 on the tiny flagship: both evals, the plain-version rerun and
    the rank list; on the CPU the launch checks only log."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "REHEARSAL", True)
    cfg, model, _, _ = cs.build_models(CPU)
    cache, _ = cs.build_train_data(cfg, CPU)
    val, nq = cs.eval_cache_from(cache, cfg)
    assert not val.train and nq == 80 and val.images.shape[0] == 320
    assert val.pids[:nq].unique().numel() == 40 and cache.train
    launches = cs.phase_rerank_eval(CPU, model, cache)
    assert launches == cs.launch_dict()
    assert rr.jaccard_min_sum.__name__ == "jaccard_min_sum"  # the swap was undone
