"""Module cost comparison of the port (demo2_tpu's tools/compare_modules.py;
reference: tools/compare_modules.py).

    python3 -m demo2_tpu_torch.tools.compare_modules [--tiny] [--cpu]

Prints the parameter count and the forward GFLOPs at batch 1
(utils/profiling.py::count_params / model_flops) of DeMo on CLIP ViT-B/16 in
five module configurations: Baseline, HDM+ATM, SDTPS, DGAFv3, SDTPS+DGAFv3.
`--tiny` shrinks the backbone (2 blocks, width 64) and the images (64x32).
It runs on cuda:0 unless `--cpu` is given; on the CPU in f32 without the
block kernels, as JAX runs off the TPU.  Unlike JAX, a failed count is
raised, not printed as nan.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

VARIANTS = {
    "Baseline": {},
    "HDM+ATM": {"HDM": True, "ATM": True, "HEAD": 4, "GLOBAL_LOCAL": True},
    "SDTPS": {"USE_SDTPS": True},
    "DGAFv3": {"USE_DGAF": True},
    "SDTPS+DGAFv3": {"USE_SDTPS": True, "USE_DGAF": True},
}
NUM_CLASSES, CAMERA_NUM = 171, 6


def build(cfg_mods: dict, tiny: bool, device: torch.device):
    """(cfg, model) of one variant, its weights from seed 0."""
    from ..config import get_cfg_defaults
    from ..models import make_model

    cfg = get_cfg_defaults()
    cfg.MODEL.TRANSFORMER_TYPE = "ViT-B-16"
    cfg.MODEL.SIE_COE = 1.0
    cfg.MODEL.ID_LOSS_WEIGHT = 0.25
    if tiny:
        cfg.INPUT.SIZE_TRAIN = (64, 32)
        cfg.TPU.BACKBONE_DEPTH = 2
        cfg.TPU.BACKBONE_WIDTH = 64
        cfg.TPU.BACKBONE_HEADS = 2
    if device.type == "cpu":
        cfg.TPU.USE_FLASH_ATTENTION = False
        cfg.TPU.COMPUTE_DTYPE = "float32"
    for k, v in cfg_mods.items():
        setattr(cfg.MODEL, k, v)
    cfg.freeze()
    return cfg, make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=device,
                           generator=torch.Generator().manual_seed(0))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Print the table; returns {variant: (params, flops)}."""
    from ..utils.profiling import count_params, model_flops

    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda:0)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); pass --cpu "
                           "to run on the CPU")
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)

    print(f"{'variant':16s} {'params (M)':>12s} {'fwd GFLOPs':>12s}")
    rows = {}
    for name, mods in VARIANTS.items():
        cfg, model = build(mods, args.tiny, device)
        h, w = cfg.INPUT.SIZE_TRAIN
        images = torch.zeros(1, 3, h, w, 3, device=device)
        cams = torch.zeros(1, dtype=torch.long, device=device)
        n = count_params(model)
        flops = model_flops(model, images, cams)["flops"]
        rows[name] = (n, flops)
        print(f"{name:16s} {n / 1e6:12.2f} {flops / 1e9:12.2f}")
    return rows


if __name__ == "__main__":
    main()
