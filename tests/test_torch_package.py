"""The port as a package: it imports without JAX or PyYAML, its config is
the JAX package's config (the YAML files under configs/, CLI opts and --set
overrides merge alike), and configurations outside the ported slices raise."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
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
CONFIG_FILES = sorted(str(p.relative_to(REPO / "configs")) for p in REPO.glob("configs/*/*.yml"))

_BLOCKED_IMPORT = """
import sys
for name in ("jax", "flax", "demo2_tpu", "yaml", "PIL", "regex", "ftfy"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import demo2_tpu_torch
for m in pkgutil.walk_packages(demo2_tpu_torch.__path__, "demo2_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
for name in ("ops.norm", "utils.reranking", "utils.metrics", "visualize.rank_list", "engine.eval",
             "tools.bench_kernel_ablate", "config.yaml_loader", "models.hdm_atmoe", "models.sacr",
             "models.lif", "models.frca", "models.sdtps_variants", "ops.conv", "data.loader",
             "data.native", "data.transforms", "data.datasets", "data.sampler", "utils.logger",
             "utils.meter", "utils.iotools", "utils.metrics_log", "utils.converters",
             "tools.train", "tools.test", "tools.quality_gate", "tools.make_synthetic_jpegs",
             "tools.arch_knobs", "losses.metric_learning", "utils.ref_convert", "utils.bpe",
             "models.clip_text", "models.t2t", "models.resnet", "models.osnet", "ops.quant",
             "utils.profiling", "visualize.saliency", "visualize.embedding",
             "visualize.similarity", "tools.gradcam", "tools.miss_sweep",
             "tools.compare_modules", "tools.diagnose_training", "tools.run_experiments",
             "parallel", "parallel.mesh", "parallel.multihost", "parallel.collectives"):
    assert "demo2_tpu_torch." + name in sys.modules, name
from demo2_tpu_torch.data.loader import pil_error
assert pil_error().startswith("PIL does not import")
assert "tensorboard" not in sys.modules
assert not {"matplotlib", "sklearn"} & set(sys.modules)  # imported inside the plotting functions
cfg = demo2_tpu_torch.config.get_cfg_defaults()
cfg.merge_from_list(chip_smoke.YAML_KEYS["RGBNT201/DeMo.yml"])  # needs no PyYAML
assert cfg.MODEL.HDM and cfg.MODEL.HEAD == 4
from demo2_tpu_torch.models import DeMoLegacy, DeMoParallel
assert DeMoLegacy and DeMoParallel
from demo2_tpu_torch.utils import bpe  # without regex (as on the card's machine): re's pattern
assert bpe._re is None and bpe.tokenize("A photo of a X X X X person.")[0, :3].tolist() == [49406, 320, 1125]
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


def _from_file(cfg_mod, path):
    return _tree(cfg_mod.get_cfg_defaults().merge_from_file(str(REPO / "configs" / path)))


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_yaml_file_gives_the_jax_packages_tree(path):
    assert len(CONFIG_FILES) == 21
    tree = _from_file(tcfg, path)
    assert tree == _from_file(jcfg, path)
    assert tree != _tree(tcfg.get_cfg_defaults())


def test_merge_from_list_and_apply_overrides_match_jax():
    opts = ["MODEL.HDM", "True", "MODEL.USE_FRCA", "None", "MODEL.HEAD", 4,
            "MODEL.SDTPS_SPARSE_RATIO", "0.7", "MODEL.STRIDE_SIZE", "(12, 12)",
            "INPUT.SIZE_TRAIN", [128, 256], "TEST.MISS", "None", "MODEL.DGAF_VERSION", "v1",
            "SOLVER.BASE_LR", 1, "OUTPUT_DIR", "./out"]
    sets = ["MODEL.ATM=yes", "MODEL.GLOBAL_LOCAL=0", "SOLVER.IMS_PER_BATCH=32",
            "SOLVER.MARGIN=0.5", "TEST.MISS=nt", "MODEL.TRANSFORMER_TYPE=ViT-B-16"]
    trees = []
    for cfg_mod, presets in ((jcfg, jpresets), (tcfg, tpresets)):
        cfg = cfg_mod.get_cfg_defaults().merge_from_list(opts)
        presets.apply_overrides(cfg, sets)
        trees.append(_tree(cfg))
    assert trees[0] == trees[1]
    m = trees[1]["MODEL"]
    assert m["HDM"] is True and m["USE_FRCA"] is None and m["STRIDE_SIZE"] == (12, 12)
    assert m["ATM"] is True and m["GLOBAL_LOCAL"] is False and trees[1]["TEST"]["MISS"] == "nt"
    for bad in (["MODEL.HDM"], ["MODEL.HEAD", "four"], ["TPU.INT8_MLP", False]):
        with pytest.raises((ValueError, TypeError)):
            tcfg.get_cfg_defaults().merge_from_list(bad)
    with pytest.raises(KeyError, match="NOT_A_KEY"):
        from demo2_tpu_torch.config.yaml_loader import _merge_dict
        _merge_dict(tcfg.get_cfg_defaults(), {"MODEL": {"NOT_A_KEY": 1}})


@pytest.mark.parametrize("path", sorted(chip_smoke.YAML_KEYS))
def test_chip_smoke_yaml_keys_are_the_files(path):
    """chip_smoke.py sets these files' keys with merge_from_list: the card's
    machine has no PyYAML."""
    cfg = tcfg.get_cfg_defaults().merge_from_list(chip_smoke.YAML_KEYS[path])
    assert _tree(cfg) == _from_file(tcfg, path)


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_the_port_builds_fourteen_of_the_yaml_files(path):
    """All twenty-one files build (the name is the test's first slice's, of
    fourteen): the Baseline, DeMo (HDM + ATMoE), SDTPS, DGAF and SDTPS +
    DGAF files, and FRCA, SACR, LIF and DeMo_Parallel's."""
    assert len(CONFIG_FILES) == 21
    cfg = tcfg.get_cfg_defaults().merge_from_file(str(REPO / "configs" / path))
    tpresets.apply_tiny(cfg)
    model = make_model(cfg, 6, 4, device=CPU, generator=generator())
    h, w = cfg.INPUT.SIZE_TEST
    emb = model(torch.zeros(2, 3, h, w, 3), torch.zeros(2, dtype=torch.long))["embedding"]
    assert emb.shape == (2, model.embed_dim)
    assert bool(torch.isfinite(emb).all())


def test_miss_masks_are_the_jax_packages():
    assert MISS_MASKS == J_MISS_MASKS
    assert miss_mask("nt", device=CPU).tolist() == [1.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="TEST.MISS"):
        miss_mask("rnt", device=CPU)


@pytest.fixture
def one_torch_thread():
    """The port's side on one thread: the suite runs several workers, each
    with its own pool, and spinning pools oversubscribe the cores (the
    ResNet and OSNet trunks below are the heaviest torch work of a test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flagship_tiny():
    cfg = tcfg.get_cfg_defaults()
    tpresets.apply_flagship(cfg, on_tpu=False)
    tpresets.apply_tiny(cfg)
    return cfg


@pytest.mark.parametrize("section,key,value", [
    ("TPU", "PIPELINED_AUGMENT", True),
])
def test_training_configs_outside_the_slice_raise(section, key, value):
    cfg = _flagship_tiny()
    setattr(getattr(cfg, section), key, value)
    model = make_model(cfg, 6, 4, device=CPU, generator=generator())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_train_state(cfg, model, steps_per_epoch=4)


def test_num_devices_above_one_in_one_process_raises_naming_the_launch():
    """D12 (demo2_tpu_torch/parallel/mesh.py): TPU.NUM_DEVICES 4 trains
    data-parallel over four ranks; in one process, without a process group,
    do_train raises a ValueError naming the torchrun launch, where JAX's
    make_mesh would take four local devices."""
    from demo2_tpu_torch.engine.train import do_train

    cfg = _flagship_tiny()
    cfg.TPU.NUM_DEVICES = 4
    model = make_model(cfg, 6, 4, device=CPU, generator=generator())
    state = create_train_state(cfg, model, steps_per_epoch=4)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4 -m "
                                         "demo2_tpu_torch.tools.train --distributed"):
        do_train(cfg, state, None, None)


@pytest.mark.parametrize("section,key,value", [
    ("TPU", "FUSED_MLP_TRAIN", True),
    ("TPU", "PALLAS_LN_BWD", True),
    ("TEST", "RE_RANKING", "yes"),
    ("DATASETS", "NAMES", "MSVR310"),
    ("TPU", "EVAL_ON_DEVICE", False),
    ("MODEL", "USE_DGAF", False),
    ("MODEL", "DGAF_VERSION", "v1"),
    ("MODEL", "HDM", True),
    ("MODEL", "GLOBAL_LOCAL", True),
    ("MODEL", "ARCH", "DeMo_Parallel"),
    ("MODEL", "ARCH", "DeMoBeiyong"),
    ("MODEL", "USE_FRCA", True),
    ("MODEL", "SDTPS_VARIANT", "complete"),
    ("TPU", "DATA_CACHE", "host"),
    ("MODEL", "METRIC_LOSS_TYPE", "triplet_center"),
    ("TPU", "REMAT_BACKBONE", True),
    ("TPU", "ENABLE_COSINE_SCHEDULE", True),
    ("MODEL", "FROZEN", True),
    ("MODEL", "ADAPTER", True),
    ("MODEL", "PROMPT", True),
    ("MODEL", "TRANSFORMER_TYPE", "t2t_vit_t_14"),
    ("MODEL", "TRANSFORMER_TYPE", "resnet50_ibn_a"),
    ("MODEL", "TRANSFORMER_TYPE", "osnet_x0_25"),
    ("TPU", "INT8_MLP", "dynamic"),
])
def test_configs_inside_the_slices_train_and_evaluate(section, key, value, tmp_path,
                                                      one_torch_thread):
    """One train step and one eval under each configuration the port once
    refused: the fused MLP in training, the LayerNorm backward flag,
    re-ranking, MSVR310's scene protocol, ranking off the device, SDTPS
    without DGAF, DGAF v1 (over GlobalLocalFuse, which it needs beside
    SDTPS), the HDM + ATMoE branch, GLOBAL_LOCAL, the nine-head
    DeMoParallel, the DeMoBeiyong cascade (DeMoLegacy), the FRCA selector,
    SDTPSComplete, the host loader (TPU.DATA_CACHE "host": the step and
    the eval over data pipes), center loss (the centers move), remat of the
    backbone, the timm cosine schedule (with SOLVER.LR_SCHEDULER
    'cosine'), and the CLIP tower's tuning paths: FROZEN (LoRA of rank 4 on
    q, k and v; the frozen backbone unchanged by the step), the FFN adapter
    and the modality prompts, the other backbones: T2T-ViT, ResNet-50
    IBN-a and OSNet (the flagship fusion at the width each gives), and the
    int8 MLP forward (TPU.INT8_MLP)."""
    from demo2_tpu_torch.data.datasets import SyntheticTriModal
    from demo2_tpu_torch.data.device_cache import DeviceCache
    from demo2_tpu_torch.data.loader import TriModalDataPipe, device_batches
    from demo2_tpu_torch.data.transforms import EvalTransform, TrainTransform
    from demo2_tpu_torch.engine.eval import run_eval
    from demo2_tpu_torch.engine.train import build_host_train_step, build_train_step

    cfg = _flagship_tiny()
    setattr(getattr(cfg, section), key, value)
    if key == "FUSED_MLP_TRAIN":
        cfg.TPU.USE_FLASH_ATTENTION = True  # the flag acts on the fused blocks only
    if key == "DGAF_VERSION":
        cfg.MODEL.GLOBAL_LOCAL = True  # v1 beside SDTPS needs it (the next test)
    if key == "ENABLE_COSINE_SCHEDULE":
        cfg.SOLVER.LR_SCHEDULER = "cosine"  # the knob acts on this scheduler only
    ds = SyntheticTriModal(num_pids=8, imgs_per_pid=4, image_size=tuple(cfg.INPUT.SIZE_TRAIN))
    model = make_model(cfg, 8, 4, device=CPU, generator=generator())
    state = create_train_state(cfg, model, steps_per_epoch=4)
    val_samples = ds.query + ds.gallery
    bs = cfg.SOLVER.IMS_PER_BATCH
    if key == "DATA_CACHE":
        size = tuple(cfg.INPUT.SIZE_TRAIN)
        pipe = TriModalDataPipe(ds.train, ds, TrainTransform(size=size), bs, num_workers=2)
        (_, *batch), = device_batches(pipe, np.arange(bs), CPU)
        assert torch.isfinite(build_host_train_step(cfg, model, state, CPU)(*batch)["loss"])
        val = TriModalDataPipe(val_samples, ds, EvalTransform(size=size),
                               cfg.TEST.IMS_PER_BATCH, num_workers=2)
    else:
        train = DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True, cfg=cfg,
                                        device=CPU)
        step = build_train_step(cfg, model, state, train)
        centers = None if state.centers is None else state.centers.clone()
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        assert torch.isfinite(step(torch.arange(bs))["loss"])
        frozen = {k for k, p in model.named_parameters() if not p.requires_grad}
        assert bool(frozen) == (key == "FROZEN")
        assert all(torch.equal(p, before[k]) for k, p in model.named_parameters() if k in frozen)
        assert (centers is None) == (key != "METRIC_LOSS_TYPE")
        assert centers is None or not torch.equal(centers, state.centers)
        val = DeviceCache.from_arrays(ds.render_all(val_samples), val_samples, train=False,
                                      cfg=cfg, device=CPU)
    cmc, m_ap = run_eval(cfg, model, val, len(ds.query), rank_list_path=str(tmp_path / "re.txt"))
    assert cmc.shape == (len(ds.gallery),) and 0.0 < m_ap <= 1.0
    assert (tmp_path / "re.txt").read_text().startswith("rank list file")


def test_dgaf_v1_beside_sdtps_without_global_local_raises_as_jax_does():
    from demo2_tpu.models import make_model as j_make_model

    cfg = _flagship_tiny()
    cfg.MODEL.DGAF_VERSION = "v1"
    h, w = cfg.INPUT.SIZE_TEST
    with pytest.raises(ValueError, match="DGAF V1 requires GLOBAL_LOCAL"):
        j_make_model(cfg, 6, 4).init({"params": jax.random.PRNGKey(0)},
                                     np.zeros((2, 3, h, w, 3), np.float32),
                                     np.zeros((2,), np.int32))
    with pytest.raises(ValueError, match="DGAF V1 requires GLOBAL_LOCAL"):
        make_model(cfg, 6, 4, device=CPU, generator=generator())


def test_remat_backbone_on_the_imagenet_vit_trains_as_without_remat():
    """The ImageNet ViT trains with REMAT_BACKBONE: its training forward is
    the one without remat (the same weights and draws), and
    create_train_state takes it."""
    cfg = _flagship_tiny()
    cfg.MODEL.TRANSFORMER_TYPE = "vit_base_patch16_224"
    cfg.TPU.BACKBONE_WIDTH = cfg.TPU.BACKBONE_HEADS = -1
    cfg.TPU.BACKBONE_DEPTH = 1
    plain = make_model(cfg, 6, 4, device=CPU, generator=generator())
    cfg.TPU.REMAT_BACKBONE = True
    model = make_model(cfg, 6, 4, device=CPU, generator=generator())
    images = torch.zeros(2, 3, 64, 32, 3)
    cams = torch.zeros(2, dtype=torch.long)
    assert model(images, cams)["embedding"].shape == (2, 3 * 768)
    got, want = (m(images, cams, train=True, generator=generator(3))["branches"]
                 for m in (model, plain))
    assert list(got) == list(want)
    for k in got:
        assert all(torch.equal(a, b) for a, b in zip(got[k], want[k])), k
    assert create_train_state(cfg, model, steps_per_epoch=4).step == 0


def test_seeded_init_is_deterministic():
    cfg = _flagship_tiny()
    a = make_model(cfg, 6, 4, device=CPU, generator=generator(7)).state_dict()
    b = make_model(cfg, 6, 4, device=CPU, generator=generator(7)).state_dict()
    c = make_model(cfg, 6, 4, device=CPU, generator=generator(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.base.proj"], c["backbone.base.proj"])
