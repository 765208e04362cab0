"""Config presets, copied from demo2_tpu/config/presets.py.

`apply_flagship` is the flagship recipe (DeMo SDTPS + DGAF v3 on CLIP
ViT-B-16); `apply_tiny` the CPU-test shrink; `apply_overrides` the
"SEC.KEY=value" strings of a --set option.  tests/test_torch_package.py
asserts that each leaves the same tree as its JAX-package original.
"""

from __future__ import annotations


def apply_flagship(cfg, on_tpu: bool) -> None:
    """Flagship recipe.  `on_tpu` keeps the JAX package's name: True selects
    bf16 compute and the fused block kernels (on the card, the CUDA ones)."""
    cfg.MODEL.TRANSFORMER_TYPE = "ViT-B-16"
    cfg.MODEL.USE_SDTPS = True
    cfg.MODEL.USE_DGAF = True
    cfg.MODEL.DGAF_VERSION = "v3"
    cfg.MODEL.ID_LOSS_WEIGHT = 0.25
    cfg.MODEL.TRIPLET_LOSS_WEIGHT = 1.0
    cfg.SOLVER.OPTIMIZER_NAME = "Adam"
    cfg.SOLVER.BASE_LR = 3.5e-4
    cfg.SOLVER.IMS_PER_BATCH = 64
    cfg.DATALOADER.NUM_INSTANCE = 8
    cfg.DATASETS.NAMES = "RGBNT201"
    cfg.TPU.DATA_CACHE = "device"
    cfg.TPU.COMPUTE_DTYPE = "bfloat16" if on_tpu else "float32"
    cfg.TPU.USE_FLASH_ATTENTION = on_tpu
    cfg.TPU.BF16_MOMENTS = on_tpu
    cfg.TPU.BF16_SECOND_MOMENT = on_tpu


def apply_tiny(cfg) -> None:
    """CPU-test shrink: tiny backbone + 64x32 images + small batches."""
    cfg.TPU.BACKBONE_DEPTH = 2
    cfg.TPU.BACKBONE_WIDTH = 64
    cfg.TPU.BACKBONE_HEADS = 2
    cfg.INPUT.SIZE_TRAIN = (64, 32)
    cfg.INPUT.SIZE_TEST = (64, 32)
    cfg.SOLVER.IMS_PER_BATCH = 16
    cfg.DATALOADER.NUM_INSTANCE = 2


def apply_overrides(cfg, overrides, log=None) -> None:
    """Apply "SEC.KEY=value" strings, each value coerced to the current
    attribute's type (a bool accepts 1/true/yes/on, case-insensitive)."""
    for ov in overrides:
        path, _, raw = ov.partition("=")
        sec, _, key = path.partition(".")
        node = getattr(cfg, sec)
        cur = getattr(node, key)
        if isinstance(cur, bool):
            val = raw.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        else:
            val = raw
        setattr(node, key, val)
        if log is not None:
            log(f"override: {sec}.{key} = {val!r}")
