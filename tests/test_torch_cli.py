"""The port's training and evaluation CLIs (demo2_tpu_torch/tools/train.py,
tools/test.py) on the CPU, end to end on a JPEG tree: the tiny flagship
trained 2 epochs through `opts` with each TPU.DATA_CACHE, its log, metrics
file and checkpoints, then the eval CLI reproducing the run's mAP from the
checkpoints; --resume and MODEL.PRETRAIN_PATH_T; the options that are not
ported raise naming the roadmap, and without MODEL.DEVICE cpu the entry
points need a card."""

import json

import numpy as np
import pytest
import torch

from demo2_tpu_torch.data import device_cache as tdc
from demo2_tpu_torch.tools import test as ttest
from demo2_tpu_torch.tools import train as ttrain
from tools.make_synthetic_jpegs import generate
from torch_port_helpers import import_tensorboard_without_tensorflow

TINY_FLAGSHIP = [
    "MODEL.TRANSFORMER_TYPE", "ViT-B-16", "MODEL.USE_SDTPS", "True", "MODEL.USE_DGAF", "True",
    "MODEL.ID_LOSS_WEIGHT", "0.25", "SOLVER.OPTIMIZER_NAME", "Adam", "SOLVER.BASE_LR", "3.5e-4",
    "TPU.COMPUTE_DTYPE", "float32", "TPU.BACKBONE_DEPTH", "2", "TPU.BACKBONE_WIDTH", "64",
    "TPU.BACKBONE_HEADS", "2", "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
    "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.NUM_INSTANCE", "2", "DATALOADER.NUM_WORKERS", "2",
    "TEST.IMS_PER_BATCH", "16", "DATASETS.NAMES", "RGBNT201",
]


@pytest.fixture(scope="module", autouse=True)
def _tensorboard_without_tensorflow():
    """The train CLI's TensorBoard writer on its stub (torch_port_helpers)."""
    import_tensorboard_without_tensorflow()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return generate(str(root), num_pids=4, imgs_per_pid=4, test_pids=3, test_imgs_per_pid=3,
                    num_cams=3, src_size=(72, 36))


@pytest.fixture(autouse=True)
def _decode_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(tdc, "DECODE_CACHE_DIR", str(tmp_path / "decoded"))


def _opts(tree, out, data_cache):
    return TINY_FLAGSHIP + ["MODEL.DEVICE", "cpu", "DATASETS.ROOT_DIR", tree,
                            "TPU.DATA_CACHE", data_cache, "OUTPUT_DIR", str(out)]


@pytest.mark.parametrize("data_cache", ["host", "device"])
def test_train_then_test_reproduces_the_map(data_cache, tree, tmp_path):
    out = tmp_path / "run"
    opts = _opts(tree, out, data_cache)
    state, best = ttrain.main(["--exp_name", "cli"] + opts + [
        "SOLVER.MAX_EPOCHS", "2", "SOLVER.EVAL_PERIOD", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
        "SOLVER.LOG_PERIOD", "1"])
    assert [e["epoch"] for e in state.history] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in state.history)
    rows = [json.loads(line) for line in (out / "cli_metrics.jsonl").read_text().splitlines()]
    assert {r["tag"] for r in rows} == {"Train/Loss", "Train/Acc", "Train/LR", "Val/mAP",
                                        "Val/Rank-1", "Val_Best/mAP"}
    assert list(out.glob("train_log_*.txt"))
    assert list((out / "checkpoints_best").glob("step_*.pt"))

    last = state.history[-1]
    cmc, m_ap = ttest.main(opts + ["TEST.WEIGHT", str(out / "checkpoints")])
    assert (m_ap, cmc[0]) == (last["mAP"], last["Rank-1"])
    cmc, m_ap = ttest.main(opts + ["TEST.WEIGHT", str(out / "checkpoints_best")])
    assert (m_ap, cmc[0]) == (best["mAP"], best["Rank-1"])
    assert list(out.glob("test_log_*.txt"))


@pytest.mark.parametrize("flag,item", [(["--distributed"], "DDP")])
def test_options_not_ported_raise_naming_the_roadmap(flag, item, tree, tmp_path):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        ttrain.main(flag + _opts(tree, tmp_path, "host"))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tree, tmp_path, monkeypatch):
    """Nothing falls back to the CPU: without MODEL.DEVICE cpu (or a device
    from the caller) and without a card, the CLIs raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = [o for o in _opts(tree, tmp_path, "host") if o != "cpu"]
    opts[opts.index("MODEL.DEVICE")] = "MODEL.NAME"
    opts.insert(opts.index("MODEL.NAME") + 1, "DeMo")
    for main in (ttrain.main, ttest.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(opts)
    cfg = ttrain.load_config("", [])
    assert ttrain.entry_device(cfg, "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ttrain.entry_device(cfg) == torch.device("cuda", 0)


def test_resume_and_pretrained_backbone(tree, tmp_path):
    """--resume continues a run's checkpoints from its step; MODEL.
    PRETRAIN_PATH_T loads a CLIP visual tower into the backbone (a missing
    file raises)."""
    out = tmp_path / "run"
    opts = _opts(tree, out, "device") + ["SOLVER.CHECKPOINT_PERIOD", "1"]
    first, _ = ttrain.main(opts + ["SOLVER.MAX_EPOCHS", "1"])
    resumed, _ = ttrain.main(["--resume", str(out / "checkpoints")] + opts +
                             ["SOLVER.MAX_EPOCHS", "2"])
    assert [e["epoch"] for e in resumed.history] == [2]
    assert resumed.step == 2 * first.step

    rng = np.random.default_rng(0)
    base = first.model.backbone.base
    sd = {"visual." + k.replace("resblocks", "transformer.resblocks"):
          torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
          for k, v in base.state_dict().items()}
    torch.save(sd, tmp_path / "clip.pt")
    state, _ = ttrain.main(opts + ["SOLVER.MAX_EPOCHS", "0", "MODEL.PRETRAIN_PATH_T",
                                   str(tmp_path / "clip.pt")])
    got = state.model.backbone.base.state_dict()
    assert torch.equal(got["conv1.weight"], sd["visual.conv1.weight"])
    assert torch.equal(got["resblocks.1.mlp.c_fc.bias"],
                       sd["visual.transformer.resblocks.1.mlp.c_fc.bias"])
    with pytest.raises(FileNotFoundError, match="PRETRAIN_PATH_T"):
        ttrain.main(opts + ["MODEL.PRETRAIN_PATH_T", str(tmp_path / "missing.pt")])
