"""Missing-modality evaluation sweep of the port (demo2_tpu's
tools/miss_sweep.py; reference: test_net.py run once per TEST.MISS).

    python3 -m demo2_tpu_torch.tools.miss_sweep --config_file configs/RGBNT201/DeMo_SDTPS_DGAF.yml \
        [TEST.WEIGHT output/checkpoints_best] [KEY VALUE ...]

Evaluates one model under all seven conditions (full, r, n, t, rn, rt, nt):
the modality mask is an input of the eval forward (engine/eval.py::
MISS_MASKS), and under TPU.DATA_CACHE "device" the validation set is
decoded once into a DeviceCache that all seven passes read.  Logs one line
per condition and a table.  TEST.WEIGHT as in tools/test.py; device as in
tools/train.py.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

CONDITIONS = ("None", "r", "n", "t", "rn", "rt", "nt")


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """Run the sweep; returns {miss: (mAP, Rank-1)} in CONDITIONS' order."""
    from ..engine.eval import run_eval
    from ..utils.logger import setup_logger
    from .test import build_for_eval
    from .train import entry_device, load_config

    p = argparse.ArgumentParser()
    p.add_argument("--config_file", default="", type=str)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cfg = load_config(args.config_file, args.opts).freeze()
    device = entry_device(cfg, device)

    logger = setup_logger("DeMo", cfg.OUTPUT_DIR, if_train=False)
    model, val_pipe, num_query = build_for_eval(cfg, device, logger)
    data = val_pipe
    if cfg.TPU.DATA_CACHE == "device":
        from ..data.device_cache import build_device_cache

        data = build_device_cache(val_pipe, device, train=False)

    results = {}
    for miss in CONDITIONS:
        cfg.defrost()
        cfg.TEST.MISS = miss
        cfg.freeze()
        cmc, m_ap = run_eval(cfg, model, data, num_query)
        results[miss] = (m_ap, cmc[0])
        logger.info("MISS=%-4s mAP=%.1f%% Rank-1=%.1f%%", miss, m_ap * 100, cmc[0] * 100)

    logger.info("%-6s %8s %8s", "miss", "mAP", "Rank-1")
    for miss, (m_ap, r1) in results.items():
        logger.info("%-6s %7.1f%% %7.1f%%", miss, m_ap * 100, r1 * 100)
    return results


if __name__ == "__main__":
    main()
