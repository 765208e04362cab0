"""The quality gate of the port (the JAX package's tools/quality_gate.py).

    python3 -m demo2_tpu_torch.tools.quality_gate                  # the gate, on cuda:0
    python3 -m demo2_tpu_torch.tools.quality_gate --tiny           # CPU mechanics smoke
    python3 -m demo2_tpu_torch.tools.quality_gate --report-only    # no assertions
    python3 -m demo2_tpu_torch.tools.quality_gate --set TPU.USE_FLASH_ATTENTION=false
                                                                   # the plain path

Trains the flagship's production recipe (apply_flagship: CLIP ViT-B/16 at
256x128, bf16, the CUDA kernels, the decoded device cache with augmentation
on the card), or one of the other architecture families (--arch, the knobs
of tools/arch_knobs.py), on a JPEG tree of SyntheticTriModal's hard recipe
whose identity weight is low enough that training cannot saturate mAP, with
an eval after every epoch, and checks the mAP trajectory:

  * the first eval is below the band's ceiling (the task is not trivially
    separable);
  * the last eval is at least --min-gain above the first (it learns);
  * the best mAP lies in [--band-lo, --band-hi].

The run goes along the path of tools/train.py: make_dataloader over the
JPEGs, create_train_state, do_train with a writer that records the
trajectory.  The LR schedule's shape is compressed to the gate's epochs
(`gate_schedule`).  The report (JSON) goes to --report, by default
output/torch_quality_gate[_<arch>][_ref].json; the tree to --root.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import sys
import time
from typing import Optional, Sequence


class TrajectoryRecorder:
    """A writer for do_train that keeps the scalars, so the gate can check
    the mAP trajectory of its evals."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def series(self, tag):
        return [v for t, v, _ in self.scalars if t == tag]


def gate_schedule(point: str, epochs: int, warmup_override: int = -1, step_override: int = -1):
    """(warmup epochs, LR milestones) of an operating point.

    'tuned': warmup E/3 and one x0.1 milestone at 2E/3.
    'reference': the canonical recipe's proportions, warmup 10 of 50 epochs
    and two x0.1 milestones at 30 and 40 of 50 (configs/RGBNT201/DeMo.yml);
    --lr-step sets the first milestone there, the second keeping the
    recipe's spacing."""
    if point == "reference":
        warmup = warmup_override if warmup_override >= 0 else max(1, round(epochs * 10 / 50))
        if step_override >= 0:
            first = step_override
            second = first + max(1, round(epochs * 10 / 50))
        else:
            first = round(epochs * 30 / 50)
            second = round(epochs * 40 / 50)
        steps = (max(warmup + 1, first), max(warmup + 2, second))
    else:
        warmup = warmup_override if warmup_override >= 0 else max(1, epochs // 3)
        steps = (step_override if step_override >= 0 else max(warmup + 1, 2 * epochs // 3),)
    return warmup, steps


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="The quality gate (PyTorch / CUDA)")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--pids", type=int, default=96)
    ap.add_argument("--imgs-per-pid", type=int, default=12)
    ap.add_argument("--test-pids", type=int, default=32)
    ap.add_argument("--id-weight", type=float, default=None,
                    help="identity weight of the hard recipe (default: the arch's operating "
                         "point, tools/arch_knobs.py GATE_POINTS)")
    ap.add_argument("--point", default="tuned", choices=("tuned", "reference"),
                    help="the LR schedule's shape (gate_schedule)")
    ap.add_argument("--warmup-epochs", type=int, default=-1,
                    help="warmup epochs (default: by --point)")
    ap.add_argument("--lr-step", type=int, default=-1,
                    help="the (first) x0.1 milestone epoch (default: by --point)")
    ap.add_argument("--arch", default="demo", choices=("demo", "parallel", "legacy", "frca"),
                    help="architecture family (tools/arch_knobs.py ARCH_KNOBS)")
    ap.add_argument("--base-lr", type=float, default=None,
                    help="peak LR (default: the arch's operating point; the flagship's is "
                         "the recipe's)")
    ap.add_argument("--compute-dtype", default=None, choices=("bfloat16", "float32"))
    ap.add_argument("--band-lo", type=float, default=0.35)
    ap.add_argument("--band-hi", type=float, default=0.97)
    ap.add_argument("--min-gain", type=float, default=0.05,
                    help="required mAP gain of the last eval over the first")
    ap.add_argument("--root", default="output/torch_quality_gate_data",
                    help="where the JPEG tree is written")
    ap.add_argument("--report", default=None,
                    help="report JSON (default output/torch_quality_gate[_<arch>][_ref].json)")
    ap.add_argument("--set", action="append", default=[], metavar="SEC.KEY=V",
                    help="config override, applied last (config/presets.py::apply_overrides)")
    ap.add_argument("--writer", default="pil", choices=("pil", "native"),
                    help="the JPEG writer of the tree (tools/make_synthetic_jpegs.py)")
    ap.add_argument("--report-only", action="store_true",
                    help="record the trajectory, check nothing")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU mechanics smoke: tiny model, images and dataset, on the CPU")
    args = ap.parse_args(argv)
    if args.report is None:
        arch = "" if args.arch == "demo" else f"_{args.arch}"
        ref = "_ref" if args.point == "reference" else ""
        args.report = f"output/torch_quality_gate{arch}{ref}.json"
    return args


def gate_config(args: argparse.Namespace):
    """The gate's config (frozen) and the JPEG tree's source size; fills in
    the arch's operating point in `args`."""
    from ..config import get_cfg_defaults
    from ..config.presets import apply_flagship, apply_overrides, apply_tiny
    from .arch_knobs import ARCH_KNOBS, GATE_POINTS

    point = GATE_POINTS[args.arch]
    if args.id_weight is None:
        args.id_weight = point["id_weight"]
    if args.base_lr is None:
        args.base_lr = point["base_lr"]
    cfg = get_cfg_defaults()
    # The production recipe (bf16, the kernels); --tiny runs on the CPU in f32,
    # as the JAX gate's --tiny does.
    apply_flagship(cfg, on_tpu=not args.tiny)
    for k, v in ARCH_KNOBS[args.arch].items():
        setattr(cfg.MODEL, k, v)
    cfg.SOLVER.MAX_EPOCHS = args.epochs
    if args.base_lr is not None:
        cfg.SOLVER.BASE_LR = args.base_lr
    if args.compute_dtype is not None:
        cfg.TPU.COMPUTE_DTYPE = args.compute_dtype
    cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.STEPS = gate_schedule(
        args.point, args.epochs, args.warmup_epochs, args.lr_step)
    cfg.SOLVER.EVAL_PERIOD = 1
    cfg.SOLVER.LOG_PERIOD = 10
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    cfg.DATASETS.ROOT_DIR = args.root
    cfg.TEST.IMS_PER_BATCH = 128
    src = (288, 144)
    if args.tiny:
        apply_tiny(cfg)
        cfg.MODEL.DEVICE = "cpu"
        cfg.TEST.IMS_PER_BATCH = 32
        args.pids, args.imgs_per_pid, args.test_pids = 12, 8, 8
        src = (72, 36)
    apply_overrides(cfg, args.set, log=lambda m: print(m, file=sys.stderr, flush=True))
    return cfg.freeze(), src


def checks_of(maps, band_lo: float, band_hi: float, min_gain: float) -> dict:
    """The gate's checks of an mAP trajectory."""
    if not maps:
        return {"has_evals": False}
    return {"first_eval_below_ceiling": maps[0] < band_hi,
            "improves": maps[-1] >= maps[0] + min_gain,
            "best_in_band": band_lo <= max(maps) <= band_hi}


def main(argv: Optional[Sequence[str]] = None, device=None) -> int:
    """Run the gate as the command line says; returns the exit code (0 when
    it passes or with --report-only, 1 when a check fails)."""
    import torch

    from ..data.loader import make_dataloader
    from ..engine.state import create_train_state
    from ..engine.train import do_train
    from ..models import make_model
    from .make_synthetic_jpegs import generate
    from .train import entry_device, set_seed

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    cfg, src = gate_config(args)
    device = entry_device(cfg, device)
    set_seed(cfg.SOLVER.SEED)

    t0 = time.perf_counter()
    generate(args.root, num_pids=args.pids, imgs_per_pid=args.imgs_per_pid,
             test_pids=args.test_pids, test_imgs_per_pid=8, src_size=src,
             id_weight=args.id_weight, writer=args.writer)
    print(f"gate dataset ready in {time.perf_counter() - t0:.1f}s ({args.pids}x"
          f"{args.imgs_per_pid} train, id_weight {args.id_weight}, {args.writer} writer)",
          file=sys.stderr)

    train_pipe, sampler, val_pipe, num_query, num_classes, cam_num, view_num = \
        make_dataloader(cfg)
    model = make_model(cfg, num_classes, cam_num, view_num, device=device,
                       generator=torch.Generator().manual_seed(cfg.SOLVER.SEED))
    state = create_train_state(cfg, model, max(1, len(sampler) // cfg.SOLVER.IMS_PER_BATCH))
    rec = TrajectoryRecorder()
    t0 = time.perf_counter()
    state, best = do_train(cfg, state, train_pipe, sampler, val_pipe, num_query, writer=rec)
    wall = time.perf_counter() - t0

    maps = rec.series("Val/mAP")
    r1s = rec.series("Val/Rank-1")
    report = {
        "config": {
            "arch": args.arch, "point": args.point, "overrides": args.set,
            "epochs": args.epochs, "pids": args.pids, "imgs_per_pid": args.imgs_per_pid,
            "id_weight": args.id_weight, "warmup_epochs": cfg.SOLVER.WARMUP_ITERS,
            "lr_steps": list(cfg.SOLVER.STEPS), "backend": device.type,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "host",
            "base_lr": cfg.SOLVER.BASE_LR, "compute_dtype": cfg.TPU.COMPUTE_DTYPE,
            "flash_attention": cfg.TPU.USE_FLASH_ATTENTION, "writer": args.writer,
            "image_size": list(cfg.INPUT.SIZE_TRAIN), "tiny": args.tiny,
        },
        "mAP_trajectory": [round(m, 4) for m in maps],
        "rank1_trajectory": [round(r, 4) for r in r1s],
        "loss_trajectory": [round(e["loss"], 4) for e in state.history if "loss" in e],
        "best_mAP": round(best["mAP"], 4),
        "wall_seconds": round(wall, 1),
        "band": [args.band_lo, args.band_hi],
        "min_gain": args.min_gain,
    }
    checks = checks_of(maps, args.band_lo, args.band_hi, args.min_gain)
    report["checks"] = checks
    report["passed"] = all(checks.values()) and bool(maps)

    os.makedirs(osp.dirname(args.report) or ".", exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    if args.report_only:
        return 0
    if not report["passed"]:
        print("QUALITY GATE FAILED: " + ", ".join(k for k, v in checks.items() if not v),
              file=sys.stderr)
        return 1
    print("QUALITY GATE PASSED", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
