"""The port's quality gate (demo2_tpu_torch/tools/quality_gate.py) and its
dataset writer against the JAX package's tools, on the CPU: the schedule
shapes, the operating points, the trajectory recorder and the checks equal
JAX's; the port's `generate` writes JAX's tree byte for byte with PIL and
keeps its marker rule; `main --tiny` trains through do_train and writes its
report.  The gate itself runs on the card (README.md)."""

import filecmp
import glob
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import arch_knobs as j_arch_knobs  # noqa: E402  (tools/, as tests/test_quality_gate.py imports it)
import quality_gate as j_gate  # noqa: E402
from make_synthetic_jpegs import generate as j_generate  # noqa: E402

from demo2_tpu_torch.tools import arch_knobs, quality_gate  # noqa: E402
from demo2_tpu_torch.tools.make_synthetic_jpegs import generate  # noqa: E402

TINY_TREE = dict(num_pids=3, imgs_per_pid=2, test_pids=2, test_imgs_per_pid=1, src_size=(24, 12))


def test_arch_knobs_and_gate_points_are_the_jax_packages():
    assert arch_knobs.ARCH_KNOBS == j_arch_knobs.ARCH_KNOBS
    assert arch_knobs.GATE_POINTS == j_arch_knobs.GATE_POINTS


@pytest.mark.parametrize("point", ["tuned", "reference"])
def test_gate_schedule_is_the_jax_gates(point):
    for epochs in (1, 2, 3, 5, 8, 10, 30, 50, 120):
        for warmup in (-1, 0, 1, 3):
            for step in (-1, 2, 4, 7):
                assert (quality_gate.gate_schedule(point, epochs, warmup, step)
                        == j_gate.gate_schedule(point, epochs, warmup, step)), (epochs, warmup, step)
    assert quality_gate.gate_schedule("tuned", 8) == (2, (5,))


def test_trajectory_recorder_series():
    rec = quality_gate.TrajectoryRecorder()
    rec.add_scalar("Val/mAP", 0.3, 1)
    rec.add_scalar("Train/Loss", 9.0, 1)
    rec.add_scalar("Val/mAP", np.float32(0.5), 2)
    assert rec.series("Val/mAP") == [0.3, 0.5]
    assert rec.series("Val/Rank-1") == []
    assert rec.scalars[1] == ("Train/Loss", 9.0, 1)


@pytest.mark.parametrize("maps", [[], [0.2], [0.2, 0.3], [0.98, 0.99], [0.4, 0.44], [0.1, 0.2]])
def test_checks_are_the_jax_gates(maps):
    """The JAX gate computes its checks inline (tools/quality_gate.py); the
    port's checks_of gives the same dict for the same trajectory."""
    if maps:
        want = {"first_eval_below_ceiling": maps[0] < 0.97,
                "improves": maps[-1] >= maps[0] + 0.05,
                "best_in_band": 0.35 <= max(maps) <= 0.97}
    else:
        want = {"has_evals": False}
    assert quality_gate.checks_of(maps, 0.35, 0.97, 0.05) == want


def test_default_report_paths_stay_out_of_reports():
    for argv, want in (([], "output/torch_quality_gate.json"),
                       (["--arch", "legacy"], "output/torch_quality_gate_legacy.json"),
                       (["--arch", "parallel", "--point", "reference"],
                        "output/torch_quality_gate_parallel_ref.json")):
        assert quality_gate.parse_args(argv).report == want


def test_generate_with_pil_writes_the_jax_tree_byte_for_byte(tmp_path):
    j_generate(str(tmp_path / "jax"), id_weight=0.14, **TINY_TREE)
    generate(str(tmp_path / "port"), id_weight=0.14, writer="pil", **TINY_TREE)
    a, b = tmp_path / "jax" / "RGBNT201", tmp_path / "port" / "RGBNT201"
    files = sorted(os.path.relpath(p, a) for p in glob.glob(str(a / "**" / "*"), recursive=True)
                   + glob.glob(str(a / ".complete_*")) if os.path.isfile(p))
    assert files == sorted(os.path.relpath(p, b) for p in glob.glob(str(b / "**" / "*"),
                                                                    recursive=True)
                           + glob.glob(str(b / ".complete_*")) if os.path.isfile(p))
    assert len(files) == 3 * (3 * 2 + 2 * 1) + 1  # the JPEGs and the marker
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files)


def test_generate_invalidates_on_parameter_change(tmp_path):
    """The marker rule of the JAX tool (tests/test_quality_gate.py's test of
    the same name): an exact match skips, any other parameterization (the
    writer too) writes the whole tree again, one marker survives."""
    root = str(tmp_path / "d")
    base = os.path.join(root, "RGBNT201")
    sample = os.path.join(base, "train_171", "RGB", "000000_cam1_000.jpg")
    generate(root, id_weight=0.14, **TINY_TREE)
    first = open(sample, "rb").read()
    mtime = os.path.getmtime(sample)
    generate(root, id_weight=0.14, **TINY_TREE)
    assert os.path.getmtime(sample) == mtime
    generate(root, id_weight=0.30, **TINY_TREE)
    assert open(sample, "rb").read() != first
    assert len(glob.glob(os.path.join(base, ".complete_*"))) == 1
    generate(root, id_weight=0.14, **TINY_TREE)
    assert open(sample, "rb").read() == first
    generate(root, id_weight=0.14, writer="native", **TINY_TREE)
    assert open(sample, "rb").read() != first  # the port's 4:4:4 writer
    assert [os.path.basename(p) for p in glob.glob(os.path.join(base, ".complete_*"))] == [
        ".complete_3x2_2x1_24x12_c6_q95_s0_w0.14_native"]
    generate(root, num_pids=2, imgs_per_pid=2, test_pids=2, test_imgs_per_pid=1,
             src_size=(24, 12), id_weight=0.14)
    assert {f.split("_")[0] for f in os.listdir(os.path.join(base, "train_171", "RGB"))} == {
        "000000", "000001"}


def test_generate_without_pil_names_the_native_writer(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="writer='native'"):
        generate(str(tmp_path), **TINY_TREE)
    with pytest.raises(ValueError, match="writer"):
        generate(str(tmp_path), writer="png", **TINY_TREE)


def test_quality_gate_tiny_mechanics(tmp_path):
    """main --tiny on the CPU: the tree, do_train with the recorder, an eval
    an epoch, the checks and the report."""
    report = tmp_path / "qg.json"
    code = quality_gate.main(["--tiny", "--report-only", "--epochs", "2", "--root",
                              str(tmp_path / "data"), "--report", str(report)])
    assert code == 0
    rec = json.loads(report.read_text())
    assert rec["config"]["tiny"] is True and rec["config"]["backend"] == "cpu"
    assert len(rec["mAP_trajectory"]) == 2 and len(rec["loss_trajectory"]) == 2
    assert all(0.0 <= m <= 1.0 for m in rec["mAP_trajectory"])
    assert set(rec["checks"]) == {"first_eval_below_ceiling", "improves", "best_in_band"}
    assert rec["passed"] == all(rec["checks"].values())
    assert rec["mAP_trajectory"][0] < 0.9  # the hard recipe does not saturate in 2 tiny epochs
