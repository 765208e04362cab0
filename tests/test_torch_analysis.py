"""The analysis stack of the port against the JAX package on the CPU.

  * the patch probe (`patch_perturb`) of DeMo, DeMoParallel and DeMoLegacy
    is transparent, and the output holds the probed patches only with it;
  * `gradcam` (class_idx pinned, and free) against JAX's on the tiny DeMo
    with DGAF v3 alone, `gradcam_heatmaps` on the tiny Baseline, from the
    same weights (neither has SDTPS, whose input gradient is ill-conditioned
    at random weights; the Baseline's branches never read the patch tokens,
    so its Grad-CAM maps are zero), each map within 1e-4 of JAX's; a map of
    other classes or other images (the controls) is not;
  * `attention_rollout`, `save_gradcam_overlays` (the PNG bytes),
    `similarity_distributions`, `tsne_plot` and `visualize_ranked_results`
    (the PNG bytes of each) against JAX's outputs on the same inputs;
  * `count_params` equal to JAX's parameter count; `model_flops` equal to
    the analytic count of the tiny Baseline's GEMMs, and JAX's XLA count
    (which adds elementwise work) within [1, 1.25] of it;
  * SDTPS's hard mask (use_soft_masking=False) bitwise JAX's, and its
    Gumbel branch with injected noise: the same forward and input gradient
    as JAX's, that gradient the soft mask's (straight through);
  * each of the five CLIs on a tiny JPEG tree or with --tiny.

JAX's saliency functions run with their jax.grad / jax.value_and_grad
compiled (jax.jit around them: the same computation in one XLA program, as
the other parity tests compile JAX's apply); nothing of demo2_tpu/ changes.
"""

import functools
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.models.sdtps import MultiModalSDTPS as JSDTPS
from demo2_tpu.utils.profiling import count_params as j_count_params
from demo2_tpu.utils.profiling import model_flops as j_model_flops
from demo2_tpu.visualize import embedding as j_embedding
from demo2_tpu.visualize import rank_list as j_rank_list
from demo2_tpu.visualize import saliency as j_saliency
from demo2_tpu.visualize import similarity as j_similarity
from demo2_tpu_torch import visualize
from demo2_tpu_torch.config import get_cfg_defaults as t_get_cfg_defaults
from demo2_tpu_torch.config import presets as tpresets
from demo2_tpu_torch.data import device_cache as tdc
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.models.sdtps import MultiModalSDTPS
from demo2_tpu_torch.tools import (compare_modules, diagnose_training, gradcam, miss_sweep,
                                   run_experiments)
from demo2_tpu_torch.tools import test as ttest
from demo2_tpu_torch.utils.profiling import (ThroughputMeter, count_params, model_flops,
                                             profile_trace)
from torch_port_helpers import CPU, generator, load_port, n, random_variables, t

NUM_CLASSES, CAMERA_NUM = 6, 4
MAP_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_cfg(use_dgaf):
    """The tiny flagship without SDTPS: the Baseline, or DGAF v3 alone."""
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.MODEL.USE_SDTPS = False
    cfg.MODEL.USE_DGAF = use_dgaf
    return cfg.freeze()


@functools.cache
def _pair(use_dgaf=False):
    """A tiny model without SDTPS in both packages from the same random
    weights: the Baseline, or with DGAF v3 (the Baseline's branches never
    read the patch tokens, so its Grad-CAM maps are all zero)."""
    cfg = _tiny_cfg(use_dgaf)
    h, w = cfg.INPUT.SIZE_TEST
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 3, h, w, 3)).astype(np.float32)
    cams = rng.integers(0, CAMERA_NUM, 2).astype(np.int32)
    jm = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jm, images, cams, train=False)
    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                generator=generator()), variables)
    return cfg, jm, jax.tree_util.tree_map(jnp.asarray, variables), port, images, cams


@pytest.fixture
def compiled_jax_grads(monkeypatch):
    grad, value_and_grad = jax.grad, jax.value_and_grad
    monkeypatch.setattr(jax, "grad", lambda f, **kw: jax.jit(grad(f, **kw)))
    monkeypatch.setattr(jax, "value_and_grad", lambda f, **kw: jax.jit(value_and_grad(f, **kw)))


# ---------------------------------------------------------------------------
# The patch probe and the saliency maps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["DeMo", "DeMo_Parallel", "DeMoBeiyong"])
def test_patch_probe_is_transparent(arch):
    cfg = t_get_cfg_defaults()
    tpresets.apply_flagship(cfg, on_tpu=False)
    tpresets.apply_tiny(cfg)
    cfg.MODEL.ARCH = arch
    cfg.MODEL.GLOBAL_LOCAL = arch != "DeMo"
    cfg.MODEL.USE_SACR = arch == "DeMoBeiyong"
    model = make_model(cfg.freeze(), NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    h, w = cfg.INPUT.SIZE_TEST
    x = torch.randn(2, 3, h, w, 3, generator=generator(3))
    cams = torch.tensor([0, 1])
    gh, gw = model.grid
    probe = torch.zeros(3, 2, gh * gw, model.feat_dim)
    with torch.no_grad():
        plain = model(x, cams)
        probed = model(x, cams, patch_perturb=probe)
        patches, _ = model.backbone(x, cams)
    assert "patches" not in plain
    torch.testing.assert_close(probed["embedding"], plain["embedding"], rtol=0, atol=0)
    for name, (logits, _) in plain["branches"].items():
        torch.testing.assert_close(probed["branches"][name][0], logits, rtol=0, atol=0)
    # The backbone's patches (DeMoLegacy's before its SACR cascade).
    torch.testing.assert_close(probed["patches"], patches, rtol=0, atol=0)


def test_gradcam_with_pinned_classes_matches_jax(compiled_jax_grads):
    cfg, jm, variables, port, images, cams = _pair(use_dgaf=True)
    pinned = np.array([1, 4], np.int32)
    want = j_saliency.gradcam(jm, variables, jnp.asarray(images), jnp.asarray(cams),
                              class_idx=jnp.asarray(pinned))
    got = visualize.gradcam(port, t(images), t(cams).long(), class_idx=t(pinned))
    assert got.shape == want.shape == (3, 2, *port.grid)
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_TOL)
    other = visualize.gradcam(port, t(images), t(cams).long(), class_idx=t(pinned[::-1].copy()))
    assert np.abs(other - want).max() > 100 * MAP_TOL
    # Without class_idx: each sample's argmax class of the same forward.
    with torch.no_grad():
        top = port(t(images), t(cams).long())["branches"]["dgaf"][0].argmax(-1)
    np.testing.assert_array_equal(visualize.gradcam(port, t(images), t(cams).long()),
                                  visualize.gradcam(port, t(images), t(cams).long(),
                                                    class_idx=top))
    assert all(p.requires_grad for p in port.parameters())  # restored after the call


def test_gradcam_heatmaps_match_jax(compiled_jax_grads):
    cfg, jm, variables, port, images, cams = _pair()
    want = j_saliency.gradcam_heatmaps(jm, variables, jnp.asarray(images), jnp.asarray(cams),
                                       jm.patch_grid)
    got = visualize.gradcam_heatmaps(port, t(images), t(cams).long(), port.grid)
    np.testing.assert_allclose(got, want, rtol=0, atol=MAP_TOL)
    shifted = visualize.gradcam_heatmaps(port, t(images[::-1].copy()), t(cams).long(),
                                         port.grid)
    assert np.abs(shifted - want).max() > 100 * MAP_TOL


def test_rollout_and_overlays_are_jaxs(tmp_path):
    rng = np.random.default_rng(4)
    attn = rng.random((3, 2, 4, 9, 9))
    attn /= attn.sum(-1, keepdims=True)
    np.testing.assert_array_equal(visualize.attention_rollout(attn),
                                  j_saliency.attention_rollout(attn))
    cams = rng.random((3, 2, 4, 2)).astype(np.float32)
    images = rng.standard_normal((2, 3, 30, 14, 3)).astype(np.float32)  # grids need not divide
    mine = visualize.save_gradcam_overlays(cams, images, str(tmp_path / "port"), prefix="b0")
    theirs = j_saliency.save_gradcam_overlays(cams, images, str(tmp_path / "jax"), prefix="b0")
    assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in theirs]
    assert len(mine) == 6 and all(open(a, "rb").read() == open(b, "rb").read()
                                  for a, b in zip(mine, theirs))


def test_png_writer_without_pil_writes_the_same_pixels(tmp_path, monkeypatch):
    """D8: where PIL is missing the writer encodes with zlib; a PIL failure
    other than the missing import is raised (JAX's catches any)."""
    from PIL import Image

    from demo2_tpu_torch.visualize import saliency

    rgb = np.random.default_rng(5).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    saliency._write_png(str(tmp_path / "z.png"), rgb)
    monkeypatch.undo()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "z.png")), rgb)
    with pytest.raises(OSError):
        saliency._write_png(str(tmp_path / "missing" / "x.png"), rgb)


def _clustered(n_ids=6, per_id=4, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_ids, dim)) * 3
    feats = np.concatenate([centers[i] + rng.normal(size=(per_id, dim)) * 0.3
                            for i in range(n_ids)]).astype(np.float32)
    return feats, np.repeat(np.arange(n_ids), per_id)


def test_plots_are_jaxs(tmp_path):
    pytest.importorskip("sklearn")
    pytest.importorskip("matplotlib")
    from threadpoolctl import threadpool_limits

    feats, pids = _clustered(per_id=6)
    outs = {}
    for pkg, sim, emb, rank in (("port", visualize, visualize, visualize),
                                ("jax", j_similarity, j_embedding, j_rank_list)):
        d = tmp_path / pkg
        d.mkdir()
        s = sim.similarity_distributions(feats[:8], feats, pids[:8], pids,
                                         save_path=str(d / "kde.png"))
        with threadpool_limits(1):  # t-SNE's OpenMP pool beside the other workers
            tsne = emb.tsne_plot(feats, pids, save_path=str(d / "tsne.png"), max_ids=4)
        images = np.random.default_rng(6).random((len(pids), 3, 8, 4, 3))
        dist = np.linalg.norm(feats[:2, None] - feats[None], axis=-1)
        ranked = rank.visualize_ranked_results(dist, images[:2], images, pids[:2], pids, topk=3,
                                               save_dir=str(d / "vis"), max_queries=1)
        outs[pkg] = (s, [open(p, "rb").read() for p in [s["path"], tsne, *ranked]])
    (s, files), (s_j, files_j) = outs["port"], outs["jax"]
    assert (s["pos_mean"], s["neg_mean"]) == (s_j["pos_mean"], s_j["neg_mean"])
    assert s["pos_mean"] > s["neg_mean"] + 0.1
    assert len(files) == 3 and files == files_j


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def _analytic_baseline_flops(cfg, b):
    """2 x the multiply-adds of the tiny Baseline's GEMMs at batch b: the
    patch conv, per block qkv, scores, PV, out-proj, fc1, fc2, the
    projection to 512, the DIRECT head's classifier on the three globals."""
    c, depth = cfg.TPU.BACKBONE_WIDTH, cfg.TPU.BACKBONE_DEPTH
    h, w = cfg.INPUT.SIZE_TRAIN
    n_patch = ((h - 16) // 16 + 1) * ((w - 16) // 16 + 1)
    s, rows = n_patch + 1, 3 * b
    conv = rows * n_patch * c * 3 * 16 * 16
    block = rows * s * (c * 3 * c + 2 * s * c + c * c + 2 * c * 4 * c)
    return 2 * (conv + depth * block + rows * s * c * 512 + b * 3 * 512 * NUM_CLASSES)


def test_param_count_and_flops(tmp_path):
    cfg, jm, variables, port, images, cams = _pair()
    assert count_params(port) == j_count_params(variables["params"])
    ours = model_flops(port, t(images), t(cams).long())
    assert ours == {"flops": float(_analytic_baseline_flops(cfg, 2)), "bytes_accessed": 0.0}
    xla = j_model_flops(jm, variables, jnp.asarray(images), jnp.asarray(cams))["flops"]
    print(f"\n[flops] tiny Baseline, batch 2: port {ours['flops']:.0f}, XLA {xla:.0f} "
          f"(ratio {xla / ours['flops']:.4f})")
    assert 1.0 <= xla / ours["flops"] <= 1.25
    # The kernels' route counted through the plain one: the same count.
    cfg_f = cfg.clone()
    cfg_f.TPU.USE_FLASH_ATTENTION = True
    fused = make_model(cfg_f.freeze(), NUM_CLASSES, CAMERA_NUM, device=CPU,
                       generator=generator())
    assert model_flops(fused, t(images), t(cams).long()) == ours
    assert all(blk.fused for blk in fused.backbone.base.resblocks)  # restored
    meter = ThroughputMeter()
    meter.update(4)
    assert meter.report().startswith("Time per batch: ") and meter.report().endswith(
        "[samples/s]")
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))


# ---------------------------------------------------------------------------
# SDTPS's hard mask and its Gumbel branch
# ---------------------------------------------------------------------------

C, TOKENS, B = 32, 10, 2


def _sdtps(use_gumbel):
    rng = np.random.default_rng(7)
    patches = rng.standard_normal((3, B, TOKENS, C)).astype(np.float32)
    globals_ = rng.standard_normal((3, B, C)).astype(np.float32)
    kw = dict(sparse_ratio=0.6, use_gumbel=use_gumbel, gumbel_tau=0.7, use_cross_attn=True,
              use_soft_masking=False)
    jm = JSDTPS(embed_dim=C, **kw)
    variables = random_variables(jm, patches, globals_, seed=8)
    port = load_port(MultiModalSDTPS(C, dtype=torch.float32, device=CPU, generator=generator(),
                                     **kw), variables)
    for mlp in port.modal_weight_mlp:
        mlp.dropout = 0.0
    return jm, variables, port, patches, globals_


def test_sdtps_hard_mask_is_jaxs_bitwise():
    jm, variables, port, patches, globals_ = _sdtps(use_gumbel=False)
    _, want = jax.jit(jm.apply)(variables, patches, globals_)
    for train in (False, True):
        out, mask = port(t(patches), t(globals_), train, generator(1))
        np.testing.assert_array_equal(n(mask), np.asarray(want))
        np.testing.assert_array_equal(n(out), patches * np.asarray(want)[..., None])
    assert n(mask).sum(-1).tolist() == [[6.0] * B] * 3  # ceil(10 * 0.6) a row


def test_sdtps_gumbel_branch_matches_jax_and_is_straight_through(monkeypatch):
    jm, variables, port, patches, globals_ = _sdtps(use_gumbel=True)
    u = np.random.default_rng(9).random((3, B, TOKENS)).astype(np.float32)
    weights = np.random.default_rng(10).standard_normal((3, B, TOKENS)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)

    def j_loss(p):
        _, mask = jm.apply(variables, p, globals_, deterministic=False,
                           rngs={"gumbel": jax.random.PRNGKey(0)})
        return jnp.sum(mask * weights), mask

    (_, want_mask), want_grad = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jnp.asarray(patches))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: t(u))
    soft = {}
    sigmoid = torch.sigmoid

    def spy(x):  # the forward's last sigmoid is the Gumbel soft mask
        soft["mask"] = sigmoid(x)
        return soft["mask"]

    monkeypatch.setattr(torch, "sigmoid", spy)
    p = t(patches).requires_grad_(True)
    _, mask = port(p, t(globals_), True, generator(2))
    hard = port(t(patches), t(globals_))[1]
    np.testing.assert_array_equal(n(mask), n(hard))
    np.testing.assert_array_equal(n(mask), np.asarray(want_mask))
    (got_grad,) = torch.autograd.grad((mask * t(weights)).sum(), p)
    np.testing.assert_allclose(n(got_grad), np.asarray(want_grad), rtol=1e-4, atol=1e-6)
    assert np.abs(n(got_grad)).max() > 0
    p2 = t(patches).requires_grad_(True)
    port(p2, t(globals_), True, generator(2))
    (soft_grad,) = torch.autograd.grad((soft["mask"] * t(weights)).sum(), p2)
    np.testing.assert_array_equal(n(got_grad), n(soft_grad))


# ---------------------------------------------------------------------------
# The five CLIs
# ---------------------------------------------------------------------------

TINY_OPTS = [
    "MODEL.TRANSFORMER_TYPE", "ViT-B-16", "MODEL.USE_SDTPS", "True", "MODEL.USE_DGAF", "True",
    "MODEL.ID_LOSS_WEIGHT", "0.25", "TPU.COMPUTE_DTYPE", "float32", "TPU.BACKBONE_DEPTH", "2",
    "TPU.BACKBONE_WIDTH", "64", "TPU.BACKBONE_HEADS", "2", "INPUT.SIZE_TRAIN", "[64, 32]",
    "INPUT.SIZE_TEST", "[64, 32]", "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.NUM_INSTANCE", "2",
    "DATALOADER.NUM_WORKERS", "2", "TEST.IMS_PER_BATCH", "16", "DATASETS.NAMES", "RGBNT201",
    "MODEL.DEVICE", "cpu",
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from tools.make_synthetic_jpegs import generate

    root = tmp_path_factory.mktemp("analysis")
    return generate(str(root), num_pids=4, imgs_per_pid=4, test_pids=3, test_imgs_per_pid=3,
                    num_cams=3, src_size=(72, 36))


@pytest.fixture
def opts(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(tdc, "DECODE_CACHE_DIR", str(tmp_path / "decoded"))
    return TINY_OPTS + ["DATASETS.ROOT_DIR", tree, "OUTPUT_DIR", str(tmp_path / "out")]


def test_gradcam_cli_writes_the_overlays(opts, tmp_path):
    written = gradcam.main(["--batches", "1", "--out", "cams"] + opts)
    assert len(written) == 3 * 16 and all(p.endswith(".png") for p in written)
    assert sorted(os.listdir(tmp_path / "out" / "cams"))[0] == "b0_NI_0.png"


def test_miss_sweep_cli_runs_the_seven_conditions(opts):
    results = miss_sweep.main(opts + ["TPU.DATA_CACHE", "device"])
    assert list(results) == ["None", "r", "n", "t", "rn", "rt", "nt"]
    assert all(0.0 < m <= 1.0 for m, _ in results.values())
    cmc, m_ap = ttest.main(opts + ["TPU.DATA_CACHE", "device"])
    assert results["None"] == (m_ap, cmc[0])


def _failing_count(*args, **kwargs):
    raise RuntimeError("the count failed")


def test_compare_modules_cli_tiny(capsys, monkeypatch):
    rows = compare_modules.main(["--tiny", "--cpu"])
    assert list(rows) == list(compare_modules.VARIANTS)
    assert all(p > 0 and f > 0 for p, f in rows.values())
    assert rows["SDTPS+DGAFv3"][0] > rows["SDTPS"][0] > rows["Baseline"][0]
    assert "fwd GFLOPs" in capsys.readouterr().out
    # D9: a failed count is raised (JAX prints nan).
    monkeypatch.setattr("demo2_tpu_torch.utils.profiling.model_flops", _failing_count)
    with pytest.raises(RuntimeError, match="the count failed"):
        compare_modules.main(["--tiny", "--cpu"])


def test_train_cli_does_not_hide_a_failed_flop_count(opts, monkeypatch):
    """D7: JAX's train CLI logs "FLOP count unavailable" and trains on; the
    port's fails."""
    from demo2_tpu_torch.tools import train as ttrain

    monkeypatch.setattr("demo2_tpu_torch.utils.profiling.model_flops", _failing_count)
    with pytest.raises(RuntimeError, match="the count failed"):
        ttrain.main(opts)


def test_diagnose_training_cli(capsys, monkeypatch):
    report = diagnose_training.main(["MODEL.DEVICE", "cpu"])
    out = capsys.readouterr().out
    assert "DIAGNOSIS COMPLETE" in out and "[OK ] sdtps" in out and "[OK ] dgaf" in out
    assert np.isfinite(report["loss"]) and len(report["dead"]) < report["total"]
    # D10: the card by default (JAX's default is the CPU); with no card, it raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="MODEL.DEVICE cpu"):
        diagnose_training.main([])


def test_run_experiments_cli(opts, tmp_path, monkeypatch):
    """Each run a `python -m demo2_tpu_torch.tools.train` process: one that
    trains an epoch, one that fails (an optimizer that does not exist); the
    JSON report, the Markdown table from the metrics files, exit code 1."""
    monkeypatch.setenv("DEMO2_DECODE_CACHE_DIR", str(tmp_path / "decoded"))
    # TensorFlow not importable in the runs: TensorBoard's writer then takes
    # its own stub, as where TensorFlow is not installed (where it is, its
    # import takes seconds a process).
    block = tmp_path / "no_tensorflow" / "tensorflow"
    block.mkdir(parents=True)
    (block / "__init__.py").write_text('raise ImportError("TensorFlow is blocked")\n')
    monkeypatch.setenv("PYTHONPATH", str(block.parent))
    one_epoch = ["SOLVER.MAX_EPOCHS", "1", "SOLVER.EVAL_PERIOD", "1"]
    experiments = [["tiny", "", opts + one_epoch],
                   ["broken", "", opts + one_epoch + ["SOLVER.OPTIMIZER_NAME", "Nope"]]]
    (tmp_path / "exps.json").write_text(json.dumps(experiments))
    report = tmp_path / "report.json"
    rc = run_experiments.main(["--experiments", str(tmp_path / "exps.json"), "--report",
                               str(report)])
    runs = json.loads(report.read_text())
    assert rc == 1 and [(r["name"], r["returncode"] == 0) for r in runs] == [
        ("tiny", True), ("broken", False)]
    table = report.with_suffix(".md").read_text().splitlines()
    assert table[4].startswith("| tiny | ") and "%" in table[4]
    assert table[5] == "| broken | (missing) | | | |"
