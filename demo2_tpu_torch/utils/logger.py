"""Timestamped stdout + file logger (demo2_tpu/utils/logger.py; reference:
utils/logger.py:9-58)."""

from __future__ import annotations

import logging
import os
import sys
import time


def setup_logger(name: str = "DeMo", save_dir: str = "", if_train: bool = True):
    """The named logger at INFO to stdout and, with `save_dir`, to
    `<save_dir>/{train,test}_log_<stamp>.txt`.  Called again in one process
    (the CLIs' `main` run more than once), it keeps the one stdout handler
    and moves the file handler to the new run's file."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    if not logger.handlers:
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(formatter)
        logger.addHandler(sh)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        mode = "train" if if_train else "test"
        fh = logging.FileHandler(os.path.join(save_dir, f"{mode}_log_{stamp}.txt"))
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger
