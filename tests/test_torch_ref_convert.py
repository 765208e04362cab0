"""Migration from the reference (PyTorch DeMo2) checkpoints against the JAX
package on the CPU: the port's copy of every `convert_*` function gives
JAX's trees; random reference-layout state dicts of DeMo (SDTPS + DGAF v3,
and DeMo.yml's HDM + ATMoE) and DeMo_Parallel on the ImageNet ViT, made by
chip_smoke.reference_state_dict from the key names and shapes that
ref_convert reads, are proved right by JAX's own convert_demo /
convert_demo_parallel and graft (every parameter of JAX's model covered);
the port's load_reference_checkpoint then gives JAX's eval outputs; a CLIP
backbone checkpoint is refused by both; tools/train.py --init_pth and
tools/test.py with a .pth TEST.WEIGHT load it.  f32, DeMo's TOL_MODEL."""

import inspect
import re

import flax
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship, apply_tiny
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.utils import ref_convert as jref
from demo2_tpu_torch.data import device_cache as tdc
from demo2_tpu_torch.engine.eval import do_inference
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.tools import test as ttest
from demo2_tpu_torch.tools import train as ttrain
from demo2_tpu_torch.utils import ref_convert as tref
from tools.make_synthetic_jpegs import generate
from torch_port_helpers import (CPU, generator, import_tensorboard_without_tensorflow, n,
                                random_variables, t)

TOL_MODEL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES, CAMERA_NUM = 8, 4
ASSEMBLIES = {  # configs/ keys (chip_smoke.YAML_KEYS) on vit_base_patch16_224
    "sdtps_dgaf": "RGBNT201/DeMo_SDTPS_DGAF.yml",
    "hdm_atmoe": "RGBNT201/DeMo.yml",
    "parallel": "RGBNT201/DeMo_Parallel.yml",
}
CONVERTERS = sorted(name for name, f in vars(jref).items()
                    if name.startswith("convert_") and inspect.isfunction(f))


def _cfg(assembly=None, clip=False):
    cfg = get_cfg_defaults()
    if assembly is None:
        apply_flagship(cfg, on_tpu=False)
        cfg.MODEL.SDTPS_CROSS_ATTN_TYPE = "attention"
    else:
        cfg.merge_from_list(chip_smoke.YAML_KEYS[ASSEMBLIES[assembly]])
    apply_tiny(cfg)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.USE_FLASH_ATTENTION = True
    if not clip:
        cfg.MODEL.TRANSFORMER_TYPE = "vit_base_patch16_224"
        cfg.TPU.BACKBONE_WIDTH = cfg.TPU.BACKBONE_HEADS = -1
    return cfg.freeze()


def _flat(tree):
    return flax.traverse_util.flatten_dict(tree) if tree else {}


def _assert_trees_equal(got, want):
    if isinstance(want, tuple):  # (params, batch_stats)
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
        return
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg="/".join(k))


class _Recorder(dict):
    """A reference state dict that makes each tensor (seeded, f32) when a
    converter first reads it: 4-D unless the converter needs another rank
    (the DGAF alpha, SACR's ECA kernel, MultiModalSACRv2's modal embedding).
    A key with a list index of 2 or more is absent, so that a converter's
    loop over blocks ends."""

    def __init__(self, seed):
        super().__init__()
        self._rng = np.random.default_rng(seed)

    def __contains__(self, key):
        return dict.__contains__(self, key) or not any(
            int(i) >= 2 for i in re.findall(r"(?:^|\.)(\d+)\.", key))

    def __missing__(self, key):
        shape = ((1,) if key.endswith("_alpha") else (1, 1, 3) if key.endswith(
            "channel_attn.weight") else (3, 4) if key.endswith("modal_embed") else (2, 3, 2, 2))
        self[key] = self._rng.standard_normal(shape).astype(np.float32)
        return self[key]


# The module converters and their arguments beyond the state dict; the ones
# missing here read sub-dicts by prefix (convert_lif, convert_general_fusion,
# convert_demo, convert_demo_parallel) and are held by source below and by the
# assemblies' dicts.
MODULE_CALLS = {
    "convert_linear": ("p.",), "convert_dense": ("p.",), "convert_ln": ("p.",),
    "convert_bn": ("p.",), "convert_mha": ("p.",), "convert_bnneck": ("p.",),
    "convert_classifier_head": ("b.", "c."), "convert_sdtps": (),
    "convert_dgaf_core": (), "convert_dgaf_v1": (), "convert_dgaf_v2": (),
    "convert_dgaf_v3": (), "convert_dgaf_v3multi": (6,), "convert_dgaf_v4": (),
    "convert_sacr_core": (), "convert_sacr": (), "convert_multimodal_sacr": (),
    "convert_multimodal_sacr_v2": (), "convert_quality_predictor": (), "convert_frca": (),
    "convert_hdm": (), "convert_atmoe": (2,), "convert_global_local": (),
    "convert_imagenet_vit_backbone": (),
}


@pytest.mark.parametrize("name", CONVERTERS)
def test_every_converter_is_jaxs(name):
    """Each convert_* of the port gives JAX's tree on the same random dict
    (or, for the LoRA adapters, arrays); the ones that read sub-dicts by
    prefix have JAX's source, word for word."""
    jf, tf = getattr(jref, name), getattr(tref, name)
    if name in MODULE_CALLS:
        sd = _Recorder(seed=len(name))
        want = jf(sd, *MODULE_CALLS[name])
        _assert_trees_equal(tf(dict(sd), *MODULE_CALLS[name]), want)
        if name == "convert_sdtps":  # the shared projections too
            want = jf(sd, shared=True)
            _assert_trees_equal(tf(dict(sd), shared=True), want)
    elif name.endswith("_lora"):
        rng = np.random.default_rng(3)
        a, b = rng.standard_normal((8, 16)), rng.standard_normal((24, 4))
        args = {"convert_merged_lora": (a, b, (True, False, True), 4, 8.0),
                "convert_conv_lora": (a, b, 4, 8.0),
                "convert_embedding_lora": (a, b, 4, 8.0)}[name]
        _assert_trees_equal(tf(*args), jf(*args))
    else:
        assert inspect.getsource(tf) == inspect.getsource(jf), name


# ---------------------------------------------------------------------------
# Whole checkpoints
# ---------------------------------------------------------------------------


@flax.struct.dataclass
class _JState:  # what JAX's load_reference_checkpoint reads of a TrainState
    params: dict
    batch_stats: dict


def _models(cfg):
    h, w = cfg.INPUT.SIZE_TEST
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, np.zeros((2, 3, h, w, 3), np.float32),
                                 np.zeros((2,), np.int32), train=False, seed=21)
    port = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    return jmodel, variables, port


def _save(sd, path):
    torch.save({k: v.clone() for k, v in sd.items()}, path)
    return str(path)


@pytest.mark.parametrize("assembly", list(ASSEMBLIES))
def test_reference_checkpoint_gives_jaxs_model(assembly, tmp_path):
    """The random reference dict is right (JAX's convert + graft cover every
    parameter of JAX's model, with shapes that fit); the port converts it to
    JAX's trees; loaded by load_reference_checkpoint into each package's
    model, both give the same eval outputs."""
    cfg = _cfg(assembly)
    jmodel, variables, port = _models(cfg)
    ref = chip_smoke.reference_state_dict(port, seed=4)
    ref_np = {k: v.numpy() for k, v in ref.items()}
    convert = "convert_demo_parallel" if cfg.MODEL.ARCH == "DeMo_Parallel" else "convert_demo"
    want = getattr(jref, convert)(ref_np, cfg)
    jref.graft(variables, *want, require_full_params=True, allow_missing_in_model=True)
    _assert_trees_equal(getattr(tref, convert)(ref_np, cfg), want)

    path = _save(ref, tmp_path / "ref.pth")
    jstate = jref.load_reference_checkpoint(_JState(**variables), path, cfg)
    loaded = tref.load_reference_checkpoint(port, path, cfg)
    assert set(loaded) >= {k for k, _ in port.named_parameters()}
    assert any(k.endswith("running_var") for k in loaded)  # BatchNorm statistics grafted
    h, w = cfg.INPUT.SIZE_TEST
    rng = np.random.default_rng(22)
    images = rng.standard_normal((3, 3, h, w, 3)).astype(np.float32)
    cams = rng.integers(0, CAMERA_NUM, 3).astype(np.int32)
    jout = jax.jit(lambda v, x, c: jmodel.apply(v, x, c, None, None, train=False))(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, images, cams)
    with torch.no_grad():
        out = port(t(images), t(cams).long())
    np.testing.assert_allclose(n(out["embedding"]), np.asarray(jout["embedding"]), **TOL_MODEL)
    for name, (logits, _) in jout["branches"].items():
        np.testing.assert_allclose(n(out["branches"][name][0]), np.asarray(logits), **TOL_MODEL)


def test_clip_backbone_checkpoint_is_refused_by_both(tmp_path):
    """convert_demo converts a backbone only from the ImageNet ViT's keys: a
    CLIP DeMo's checkpoint leaves the CLIP tower uncovered, and both
    packages refuse it, naming the tower's parameters."""
    cfg = _cfg(clip=True)
    _, variables, port = _models(cfg)
    path = _save(chip_smoke.reference_state_dict(port, seed=5), tmp_path / "clip.pth")
    with pytest.raises(AssertionError, match="NOT covered.*backbone/base/"):
        jref.load_reference_checkpoint(_JState(**variables), path, cfg)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match=r"NOT covered.*backbone\.base\."):
        tref.load_reference_checkpoint(port, path, cfg)
    assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())


def test_graft_is_strict_where_asked():
    """A converted leaf the model lacks (the reference's unused gl_fuse) is
    skipped; a model parameter the trees leave uncovered raises, and the
    model is left as it was."""
    cfg = _cfg("sdtps_dgaf")
    port = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator())
    params, stats = tref.convert_demo(
        {k: v.numpy() for k, v in chip_smoke.reference_state_dict(port).items()}, cfg)
    assert "gl_fuse" in params
    filled = tref.graft(port, params, stats)
    assert not any(k.startswith("gl_fuse") for k in filled)
    assert {k for k, _ in port.named_parameters()} <= set(filled)
    del params["head_dgaf"]
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match="NOT covered.*head_dgaf"):
        tref.graft(port, params, stats)
    assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _tensorboard_without_tensorflow():
    """The train CLI's TensorBoard writer on its stub (torch_port_helpers)."""
    import_tensorboard_without_tensorflow()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref_cli")
    return generate(str(root), num_pids=4, imgs_per_pid=4, test_pids=3, test_imgs_per_pid=3,
                    num_cams=3, src_size=(72, 36))


def _cli_opts(tree, out):
    """The tiny f32 DeMo (SDTPS + DGAF v3) on vit_base_patch16_224 at two
    blocks over the JPEG tree."""
    return ["MODEL.TRANSFORMER_TYPE", "vit_base_patch16_224", "MODEL.USE_SDTPS", "True",
            "MODEL.SDTPS_CROSS_ATTN_TYPE", "attention", "MODEL.USE_DGAF", "True",
            "TPU.COMPUTE_DTYPE", "float32", "TPU.BACKBONE_DEPTH", "2",
            "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
            "SOLVER.IMS_PER_BATCH", "8", "DATALOADER.NUM_INSTANCE", "2",
            "DATALOADER.NUM_WORKERS", "2", "TEST.IMS_PER_BATCH", "16",
            "DATASETS.NAMES", "RGBNT201", "MODEL.DEVICE", "cpu", "DATASETS.ROOT_DIR", tree,
            "TPU.DATA_CACHE", "device", "OUTPUT_DIR", str(out)]


def test_clis_load_a_reference_checkpoint(tree, tmp_path, monkeypatch):
    """tools/train.py --init_pth starts from the checkpoint (0 epochs: the
    state it would train from), and tools/test.py with the .pth as
    TEST.WEIGHT evaluates the model it gives."""
    from demo2_tpu_torch.data.loader import make_dataloader

    monkeypatch.setattr(tdc, "DECODE_CACHE_DIR", str(tmp_path / "decoded"))
    opts = _cli_opts(tree, tmp_path / "run")
    cfg = ttrain.load_config("", opts).freeze()
    _, _, val, num_query, num_classes, cam_num, view_num = make_dataloader(cfg)
    model = make_model(cfg, num_classes, cam_num, view_num, device=CPU, generator=generator(9))
    ref = chip_smoke.reference_state_dict(model, seed=6)
    path = _save(ref, tmp_path / "ref.pth")
    tref.load_reference_checkpoint(model, path, cfg)
    state, _ = ttrain.main(["--init_pth", path] + opts + ["SOLVER.MAX_EPOCHS", "0"])
    for k, v in model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    np.testing.assert_array_equal(n(state.model.state_dict()["backbone.base.blocks.1.attn.qkv.weight"]),
                                  n(ref["BACKBONE.base.blocks.1.attn.qkv.weight"]))
    cmc, m_ap = ttest.main(opts + ["TEST.WEIGHT", path])
    want_cmc, want_map = do_inference(cfg, model, val, num_query)
    assert m_ap == want_map and np.array_equal(cmc, want_cmc)
