"""The port as a package: it imports without JAX, its config is the JAX
package's config, and configurations outside the ported slices raise."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import demo2_tpu.config as jcfg
import demo2_tpu.config.presets as jpresets
from demo2_tpu.engine.eval import MISS_MASKS as J_MISS_MASKS
import demo2_tpu_torch.config as tcfg
import demo2_tpu_torch.config.presets as tpresets
from demo2_tpu_torch.engine.eval import MISS_MASKS, miss_mask
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.models import make_model
from torch_port_helpers import CPU, generator

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = """
import sys
for name in ("jax", "flax", "demo2_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import demo2_tpu_torch
for m in pkgutil.walk_packages(demo2_tpu_torch.__path__, "demo2_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
for name in ("ops.norm", "utils.reranking", "utils.metrics", "visualize.rank_list", "engine.eval"):
    assert "demo2_tpu_torch." + name in sys.modules, name
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _tree(cfg):
    return {sec: (dict(vars(node)) if dataclasses.is_dataclass(node) else node)
            for sec, node in vars(cfg).items() if not sec.startswith("_")}


@pytest.mark.parametrize("preset", ["defaults", "flagship_tpu", "flagship_cpu", "tiny"])
def test_config_is_the_jax_packages_config(preset):
    trees = []
    for cfg_mod, presets in ((jcfg, jpresets), (tcfg, tpresets)):
        cfg = cfg_mod.get_cfg_defaults()
        if preset.startswith("flagship"):
            presets.apply_flagship(cfg, on_tpu=preset == "flagship_tpu")
        elif preset == "tiny":
            presets.apply_tiny(cfg)
        trees.append(_tree(cfg))
    assert trees[0] == trees[1]


def test_miss_masks_are_the_jax_packages():
    assert MISS_MASKS == J_MISS_MASKS
    assert miss_mask("nt", device=CPU).tolist() == [1.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="TEST.MISS"):
        miss_mask("rnt", device=CPU)


def _flagship_tiny():
    cfg = tcfg.get_cfg_defaults()
    tpresets.apply_flagship(cfg, on_tpu=False)
    tpresets.apply_tiny(cfg)
    return cfg


@pytest.mark.parametrize("section,key,value", [
    ("MODEL", "ARCH", "DeMo_Parallel"),
    ("MODEL", "ARCH", "DeMoBeiyong"),
    ("MODEL", "USE_DGAF", False),
    ("MODEL", "USE_FRCA", True),
    ("MODEL", "DGAF_VERSION", "v1"),
    ("MODEL", "HDM", True),
    ("MODEL", "GLOBAL_LOCAL", True),
    ("MODEL", "FROZEN", True),
    ("MODEL", "ADAPTER", True),
    ("MODEL", "PROMPT", True),
    ("MODEL", "TRANSFORMER_TYPE", "t2t_vit_t_14"),
    ("TPU", "INT8_MLP", "dynamic"),
])
def test_configs_outside_the_slice_raise(section, key, value):
    cfg = _flagship_tiny()
    setattr(getattr(cfg, section), key, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_model(cfg, 6, 4, device=CPU, generator=generator())


@pytest.mark.parametrize("section,key,value", [
    ("TPU", "FUSED_MLP_TRAIN", True),
    ("MODEL", "METRIC_LOSS_TYPE", "triplet_center"),
    ("TPU", "REMAT_BACKBONE", True),
    ("TPU", "PIPELINED_AUGMENT", True),
    ("TPU", "NUM_DEVICES", 4),
])
def test_training_configs_outside_the_slice_raise(section, key, value):
    cfg = _flagship_tiny()
    setattr(getattr(cfg, section), key, value)
    model = make_model(cfg, 6, 4, device=CPU, generator=generator())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_train_state(cfg, model, steps_per_epoch=4)
    if section == "TPU" and key in ("FUSED_MLP_TRAIN", "REMAT_BACKBONE"):
        with pytest.raises(NotImplementedError, match=key):  # the model's own part
            model(torch.zeros(2, 3, 64, 32, 3), torch.zeros(2, dtype=torch.long), train=True)


@pytest.mark.parametrize("section,key,value", [
    ("TPU", "PALLAS_LN_BWD", True),
    ("TEST", "RE_RANKING", "yes"),
    ("DATASETS", "NAMES", "MSVR310"),
    ("TPU", "EVAL_ON_DEVICE", False),
])
def test_configs_inside_the_slices_train_and_evaluate(section, key, value, tmp_path):
    """One train step and one eval under each configuration the port once
    refused: the LayerNorm backward flag, re-ranking, MSVR310's scene
    protocol, ranking off the device."""
    from demo2_tpu_torch.data.datasets import SyntheticTriModal
    from demo2_tpu_torch.data.device_cache import DeviceCache
    from demo2_tpu_torch.engine.eval import run_eval
    from demo2_tpu_torch.engine.train import build_train_step

    cfg = _flagship_tiny()
    setattr(getattr(cfg, section), key, value)
    ds = SyntheticTriModal(num_pids=8, imgs_per_pid=4, image_size=tuple(cfg.INPUT.SIZE_TRAIN))
    model = make_model(cfg, 8, 4, device=CPU, generator=generator())
    train = DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True, cfg=cfg,
                                    device=CPU)
    step = build_train_step(cfg, model, create_train_state(cfg, model, steps_per_epoch=4), train)
    assert torch.isfinite(step(torch.arange(cfg.SOLVER.IMS_PER_BATCH))["loss"])
    val_samples = ds.query + ds.gallery
    val = DeviceCache.from_arrays(ds.render_all(val_samples), val_samples, train=False, cfg=cfg,
                                  device=CPU)
    cmc, m_ap = run_eval(cfg, model, val, len(ds.query), rank_list_path=str(tmp_path / "re.txt"))
    assert cmc.shape == (len(ds.gallery),) and 0.0 < m_ap <= 1.0
    assert (tmp_path / "re.txt").read_text().startswith("rank list file")


def test_remat_backbone_on_the_imagenet_vit_raises_in_training():
    cfg = _flagship_tiny()
    cfg.MODEL.TRANSFORMER_TYPE = "vit_base_patch16_224"
    cfg.TPU.BACKBONE_WIDTH = cfg.TPU.BACKBONE_HEADS = -1
    cfg.TPU.BACKBONE_DEPTH = 1
    cfg.TPU.REMAT_BACKBONE = True
    model = make_model(cfg, 6, 4, device=CPU, generator=generator())
    images = torch.zeros(2, 3, 64, 32, 3)
    assert model(images, torch.zeros(2, dtype=torch.long))["embedding"].shape == (2, 3 * 768)
    with pytest.raises(NotImplementedError, match="REMAT_BACKBONE"):
        model(images, torch.zeros(2, dtype=torch.long), train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_train_state(cfg, model, steps_per_epoch=4)


def test_seeded_init_is_deterministic():
    cfg = _flagship_tiny()
    a = make_model(cfg, 6, 4, device=CPU, generator=generator(7)).state_dict()
    b = make_model(cfg, 6, 4, device=CPU, generator=generator(7)).state_dict()
    c = make_model(cfg, 6, 4, device=CPU, generator=generator(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.base.proj"], c["backbone.base.proj"])
