"""Evaluation CLI of the port (demo2_tpu's tools/test.py; reference:
test_net.py:9-44).

    python3 -m demo2_tpu_torch.tools.test --config_file configs/RGBNT201/DeMo.yml \
        TEST.WEIGHT OUTPUT_DIR/checkpoints [TEST.MISS nt] [KEY VALUE ...]

TEST.WEIGHT is a checkpoint directory that demo2_tpu_torch.tools.train
wrote (its latest step is loaded), or a reference-trained torch .pth / .pt
(the reference's torch.save(model.state_dict()) file), converted on load by
utils/ref_convert.py.  Device as in tools/train.py.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from .train import entry_device, load_config


def build_for_eval(cfg, device, logger):
    """(model, val_pipe, num_query) of `cfg` on `device`, TEST.WEIGHT loaded
    where it is set: a reference .pth / .pt (converted), or a checkpoint
    directory of the train CLI (its latest step)."""
    from ..data.loader import make_dataloader
    from ..engine.state import create_train_state
    from ..models import make_model
    from ..utils.checkpoint import restore_checkpoint

    _, sampler, val_pipe, num_query, num_classes, cam_num, view_num = make_dataloader(cfg)
    model = make_model(cfg, num_classes, cam_num, view_num, device=device,
                       generator=torch.Generator().manual_seed(cfg.SOLVER.SEED))
    if cfg.TEST.WEIGHT.endswith((".pth", ".pt")):
        from ..utils.ref_convert import load_reference_checkpoint

        load_reference_checkpoint(model, cfg.TEST.WEIGHT, cfg)
        logger.info("Converted reference torch checkpoint %s", cfg.TEST.WEIGHT)
    elif cfg.TEST.WEIGHT:
        state = create_train_state(cfg, model, max(1, len(sampler) // cfg.SOLVER.IMS_PER_BATCH))
        restore_checkpoint(cfg.TEST.WEIGHT, state)
        logger.info("Loaded checkpoint from %s at step %d", cfg.TEST.WEIGHT, state.step)
    return model, val_pipe, num_query


def main(argv: Optional[Sequence[str]] = None, device=None):
    """Evaluate as the command line says; returns (cmc, mAP)."""
    from ..engine.eval import do_inference
    from ..utils.logger import setup_logger

    p = argparse.ArgumentParser(description="DeMo evaluation (PyTorch / CUDA)")
    p.add_argument("--config_file", default="", type=str)
    p.add_argument("--return_pattern", default=3, type=int)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cfg = load_config(args.config_file, args.opts).freeze()
    device = entry_device(cfg, device)

    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("DeMo", cfg.OUTPUT_DIR, if_train=False)
    model, val_pipe, num_query = build_for_eval(cfg, device, logger)
    cmc, m_ap = do_inference(cfg, model, val_pipe, num_query, return_pattern=args.return_pattern)
    logger.info("Done. mAP=%.1f%% Rank-1=%.1f%%", m_ap * 100, cmc[0] * 100)
    return cmc, m_ap


if __name__ == "__main__":
    main()
