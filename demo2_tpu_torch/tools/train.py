"""Training CLI of the port (demo2_tpu's tools/train.py; reference:
train_net.py:33-132).

    python3 -m demo2_tpu_torch.tools.train --config_file configs/RGBNT201/DeMo.yml \
        DATASETS.ROOT_DIR /data [--exp_name NAME] [--resume DIR] [KEY VALUE ...]

Reads the dataset from disk (data/loader.py::make_dataloader), trains with
evaluation every SOLVER.EVAL_PERIOD epochs, writes the log and
`<exp_name or MODEL.NAME>_metrics.jsonl` (and TensorBoard events where
torch.utils.tensorboard imports) under OUTPUT_DIR, the checkpoints under
OUTPUT_DIR/checkpoints and the best under OUTPUT_DIR/checkpoints_best.
`--init_pth <ref.pth>` initialises the whole model from a reference-trained
DeMo / DeMo_Parallel checkpoint (utils/ref_convert.py).  At start it logs
the parameter count and one forward's FLOPs (utils/profiling.py).  It
runs on cuda:0 unless MODEL.DEVICE is "cpu" or the caller of `main` passes a
device; with neither and no card it raises.

`--distributed` trains data-parallel, one process a device, in the process
group a launcher describes (parallel/mesh.py::join_process_group):

    torchrun --nproc_per_node N -m demo2_tpu_torch.tools.train --distributed ...

Each rank runs on cuda:LOCAL_RANK over NCCL; with MODEL.DEVICE cpu, or a
device that the caller pins (MODEL.DEVICE cuda:N, or `main`'s `device`), the
ranks use gloo (ranks that share a card must).  SOLVER.IMS_PER_BATCH stays
the global batch; only the primary rank writes the log file, the metrics and
the checkpoints.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import join_process_group, leave_process_group, make_world


def entry_device(cfg, device=None) -> torch.device:
    """The device of an entry point: `device` where the caller gives one,
    the CPU where MODEL.DEVICE is "cpu", else cuda:0, which must exist."""
    if device is not None:
        return torch.device(device)
    if cfg.MODEL.DEVICE == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); set "
                           "MODEL.DEVICE cpu to run on the CPU")
    return torch.device("cuda", 0)


def load_config(config_file: str, opts: Sequence):
    from ..config import get_cfg_defaults

    cfg = get_cfg_defaults()
    if config_file:
        cfg.merge_from_file(config_file)
    return cfg.merge_from_list(list(opts))


def set_seed(seed: int) -> None:
    """Host RNGs and torch's default generators (reference: train_net.py:18-30)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv: Optional[Sequence[str]] = None, device=None):
    """Train as the command line says; returns (state, best)."""
    p = argparse.ArgumentParser(description="DeMo training (PyTorch / CUDA)")
    p.add_argument("--config_file", default="", type=str)
    p.add_argument("--fea_cft", default=0, type=int, help="feature pattern for eval")
    p.add_argument("--exp_name", default=None, type=str)
    p.add_argument("--local_rank", default=0, type=int)
    p.add_argument("--distributed", action="store_true", help="multi-process training")
    p.add_argument("--resume", default="", type=str,
                   help="checkpoint dir to resume the full train state from")
    p.add_argument("--init_pth", default="", type=str,
                   help="reference-trained torch .pth to initialize the full model from")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cfg = load_config(args.config_file, args.opts)
    # The reference stores --fea_cft in TEST.FEAT (train_net.py:49) and never
    # reads it; kept as it is.
    cfg.TEST.FEAT = args.fea_cft
    cfg.freeze()
    if not args.distributed:
        return _train(args, cfg, entry_device(cfg, device))
    # torch.distributed.launch passes --local_rank; torchrun sets LOCAL_RANK.
    local_rank = int(os.environ.get("LOCAL_RANK", args.local_rank))
    world = join_process_group(cfg.MODEL.DEVICE, device, local_rank)
    try:
        return _train(args, cfg, world.device)
    finally:
        leave_process_group()


def _train(args, cfg, device: torch.device):
    from ..data.loader import make_dataloader
    from ..engine.state import create_train_state
    from ..engine.train import do_train
    from ..models import make_model
    from ..utils.logger import setup_logger
    from ..utils.metrics_log import MetricsLogger, TeeWriter
    from ..utils.profiling import count_params, model_flops

    world = make_world(cfg.TPU.NUM_DEVICES, device)
    set_seed(cfg.SOLVER.SEED)
    output_dir = cfg.OUTPUT_DIR
    os.makedirs(output_dir, exist_ok=True)
    logger = setup_logger("DeMo", output_dir, if_train=True)
    logger.info("Running with config:\n%s", cfg)
    logger.info("torch %s on %s (%s)", torch.__version__, device,
                torch.cuda.get_device_name(device) if device.type == "cuda" else "host")
    if world.backend is not None:
        logger.info("data parallel: backend %s, %d ranks (this is rank %d), device %s",
                    world.backend, world.size, world.rank, device)

    train_pipe, sampler, val_pipe, num_query, num_classes, cam_num, view_num = \
        make_dataloader(cfg)
    model = make_model(cfg, num_classes, cam_num, view_num, device=device,
                       generator=torch.Generator().manual_seed(cfg.SOLVER.SEED))
    state = create_train_state(cfg, model, max(1, len(sampler) // cfg.SOLVER.IMS_PER_BATCH))
    logger.info("Total parameters: %.2fM", count_params(model) / 1e6)
    # The startup FLOP count of one eval forward at the training batch
    # (JAX tools/train.py:109-128); FLOPs do not depend on the pixels, so
    # the batch is zeros.  Unlike JAX, an error of the count is not hidden.
    h, w = cfg.INPUT.SIZE_TRAIN
    bs = cfg.SOLVER.IMS_PER_BATCH
    fl = model_flops(model, torch.zeros(bs, 3, h, w, 3, device=device),
                     torch.zeros(bs, dtype=torch.long, device=device))
    logger.info("Forward FLOPs (batch %d): %.1f GFLOPs", bs, fl["flops"] / 1e9)

    if cfg.MODEL.PRETRAIN_PATH_T:  # reference: meta_arch.py:59,66-71
        if not os.path.exists(cfg.MODEL.PRETRAIN_PATH_T):
            # A typo'd path must not train from random init silently.
            raise FileNotFoundError(f"MODEL.PRETRAIN_PATH_T={cfg.MODEL.PRETRAIN_PATH_T!r} "
                                    "does not exist")
        from ..utils.converters import load_pretrained_backbone

        loaded = load_pretrained_backbone(cfg, model, cfg.MODEL.PRETRAIN_PATH_T)
        logger.info("Loaded pretrained backbone (%d tensors) from %s", len(loaded),
                    cfg.MODEL.PRETRAIN_PATH_T)
    if args.init_pth:
        # The whole model from a reference-trained torch checkpoint, after
        # the pretrained backbone and before --resume, which wins if both
        # are given (JAX tools/train.py:161-169).
        from ..utils.ref_convert import load_reference_checkpoint

        loaded = load_reference_checkpoint(model, args.init_pth, cfg)
        logger.info("Initialized the model (%d tensors) from reference checkpoint %s",
                    len(loaded), args.init_pth)
    if args.resume:
        from ..utils.checkpoint import restore_checkpoint

        state = restore_checkpoint(args.resume, state)
        logger.info("Resumed from %s at step %d", args.resume, state.step)

    name = args.exp_name or cfg.MODEL.NAME
    tb = None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:  # TensorBoard is optional; the JSONL file is always written
        logger.info("TensorBoard unavailable (%s); JSONL metrics only", e)
    else:
        if world.primary:
            tb = SummaryWriter(os.path.join(output_dir, "tensorboard", name))
            logger.info("TensorBoard logging to %s", tb.log_dir)
    writer = TeeWriter(MetricsLogger(os.path.join(output_dir, f"{name}_metrics.jsonl")), tb)
    try:
        state, best = do_train(cfg, state, train_pipe, sampler, val_pipe, num_query,
                               checkpoint_dir=os.path.join(output_dir, "checkpoints"),
                               writer=writer, world=world)
    finally:
        writer.close()
    logger.info("Training done. Best: %s", best)
    return state, best


if __name__ == "__main__":
    main()
