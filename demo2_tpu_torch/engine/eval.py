"""Eval forward, the missing-modality masks and the eval loop over a device
cache (demo2_tpu/engine/eval.py).

`run_eval` is the JAX package's device-cache branch: the query and gallery
samples are gathered and normalised on the device, embedded, and ranked by
R1mAPEvaluator.  The host dataset loop, do_inference and MSVR310's scene
protocol come with the eval entry points (ROADMAP.md, port queue item 2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import not_ported
from ..utils.metrics import R1mAPEvaluator

MISS_MASKS = {
    "None": (1.0, 1.0, 1.0),
    "nothing": (1.0, 1.0, 1.0),  # alias used by reference YAMLs
    "r": (0.0, 1.0, 1.0),
    "n": (1.0, 0.0, 1.0),
    "t": (1.0, 1.0, 0.0),
    "rn": (0.0, 0.0, 1.0),
    "rt": (0.0, 1.0, 0.0),
    "nt": (1.0, 0.0, 0.0),
}


def miss_mask(miss: str, *, device: torch.device) -> torch.Tensor:
    """The (3,) modality mask of a TEST.MISS value."""
    if miss not in MISS_MASKS:
        raise ValueError(f"TEST.MISS={miss!r} is not a valid missing-modality pattern; "
                         f"expected one of {sorted(MISS_MASKS)}")
    return torch.tensor(MISS_MASKS[miss], dtype=torch.float32, device=device)


@torch.inference_mode()
def eval_step(model, images: torch.Tensor, camids: torch.Tensor, mask: torch.Tensor,
              viewids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eval forward: the f32 embedding of a batch."""
    return model(images, camids, viewids, mask, train=False)["embedding"]


def run_eval(cfg, model, cache, num_query: int) -> Tuple[np.ndarray, float]:
    """CMC and mAP of `model` over an eval DeviceCache holding the query
    samples then the gallery, in TEST.IMS_PER_BATCH batches, under the
    TEST.MISS modality mask."""
    if cfg.DATASETS.NAMES == "MSVR310":
        raise not_ported("MSVR310's scene protocol", "eval entry points and datasets")
    if cache.train:
        raise ValueError("run_eval needs an eval cache (normalising, not augmenting)")
    dev = cache.images.device
    mask = miss_mask(str(cfg.TEST.MISS), device=dev)
    evaluator = R1mAPEvaluator(num_query=num_query, device=dev,
                               feat_norm=cfg.TEST.FEAT_NORM == "yes",
                               reranking=cfg.TEST.RE_RANKING == "yes")
    n, bs = cache.images.shape[0], cfg.TEST.IMS_PER_BATCH
    for start in range(0, n, bs):
        idx = torch.arange(start, min(start + bs, n), device=dev)
        images, pids, camids = cache.batch(idx)
        feat = eval_step(model, images, camids, mask, cache.viewids[idx])
        evaluator.update(feat.cpu().numpy(), pids.cpu().numpy(), camids.cpu().numpy())
    return evaluator.compute()
