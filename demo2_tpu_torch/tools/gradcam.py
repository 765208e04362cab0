"""Grad-CAM overlays of the port (demo2_tpu's tools/gradcam.py; reference:
visualize/GradCAM.py).

    python3 -m demo2_tpu_torch.tools.gradcam --config_file configs/RGBNT201/DeMo_SDTPS_DGAF.yml \
        [--batches 1] [--out gradcam_vis] [--branch NAME] [TEST.WEIGHT DIR] [KEY VALUE ...]

For the first `--batches` batches of the validation set, the class-
conditional CAM of each modality (visualize/saliency.py::gradcam, through
the model's patch probe) blended on the image, written as
`<OUTPUT_DIR>/<out>/b<batch>_<RGB|NI|TI>_<i>.png`.  TEST.WEIGHT as in
tools/test.py; device as in tools/train.py.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None, device=None) -> list:
    """Write the overlays as the command line says; returns their paths."""
    from ..data.loader import device_batches
    from ..utils.logger import setup_logger
    from ..visualize import gradcam, save_gradcam_overlays
    from .test import build_for_eval
    from .train import entry_device, load_config

    p = argparse.ArgumentParser(description="DeMo Grad-CAM (PyTorch / CUDA)")
    p.add_argument("--config_file", default="", type=str)
    p.add_argument("--batches", default=1, type=int)
    p.add_argument("--out", default="gradcam_vis", type=str)
    p.add_argument("--branch", default=None, type=str,
                   help="branch whose classifier drives the CAM (default: the model's first)")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cfg = load_config(args.config_file, args.opts).freeze()
    device = entry_device(cfg, device)

    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("DeMo", cfg.OUTPUT_DIR, if_train=False)
    model, val_pipe, _ = build_for_eval(cfg, device, logger)
    out_dir = os.path.join(cfg.OUTPUT_DIR, args.out)
    order = np.arange(len(val_pipe.samples))
    written = []
    for n_iter, (batch, images, _, camids, _) in enumerate(
            device_batches(val_pipe, order, device, drop_last=False, pad_last=True)):
        if n_iter >= args.batches:
            break
        maps = gradcam(model, images, camids, branch=args.branch)
        v = batch.valid
        written += save_gradcam_overlays(maps[:, :v], batch.images[:v], out_dir,
                                         prefix=f"b{n_iter}")
    logger.info("Wrote %d CAM overlays to %s", len(written), out_dir)
    return written


if __name__ == "__main__":
    main()
