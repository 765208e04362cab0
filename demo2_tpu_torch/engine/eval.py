"""Eval forward, the missing-modality masks and the eval loop
(demo2_tpu/engine/eval.py).

`run_eval` embeds the query and gallery samples (gathered and normalised on
the device from a DeviceCache, or decoded on the host by a data pipe in
padded batches) and ranks them by R1mAPEvaluator: by the euclidean distance
or, with TEST.RE_RANKING, by k-reciprocal re-ranking; under the camera
protocol or, for MSVR310, the scene protocol with its rank list file.
`do_inference` is run_eval with the reference's log lines; over a pipe with
TPU.DATA_CACHE "device" it decodes the pipe into a cache first.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.metrics import R1mAPEvaluator

logger = logging.getLogger("DeMo")

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
              viewids: Optional[torch.Tensor] = None, return_pattern: int = 3) -> torch.Tensor:
    """The eval forward: the f32 embedding of a batch; `return_pattern`
    picks the HDM + ATMoE model's embedding (1: ori, 2: moe, 3: both)."""
    return model(images, camids, viewids, mask, train=False,
                 return_pattern=return_pattern)["embedding"]


def run_eval(cfg, model, data, num_query: int, return_pattern: int = 3,
             rank_list_path: Optional[str] = None) -> Tuple[np.ndarray, float]:
    """CMC and mAP of `model` over the query samples then the gallery, in
    TEST.IMS_PER_BATCH batches, under the TEST.MISS modality mask, on the
    embedding of `return_pattern`.  `data` is an eval DeviceCache or an eval
    data pipe (data/loader.py), whose last batch is padded and trimmed.
    DATASETS.NAMES == "MSVR310" selects the scene protocol (the viewids
    carry the scene ids) and writes the rank list to `rank_list_path`, by
    default `re.txt` as the reference does.  The ranking runs on the model's
    device, or on the CPU when TPU.EVAL_ON_DEVICE is off."""
    from ..data.device_cache import DeviceCache
    from ..data.loader import device_batches

    cached = isinstance(data, DeviceCache)
    if cached and data.train:
        raise ValueError("run_eval needs an eval cache (normalising, not augmenting)")
    dev = data.images.device if cached else next(model.parameters()).device
    mask = miss_mask(str(cfg.TEST.MISS), device=dev)
    scene_protocol = cfg.DATASETS.NAMES == "MSVR310"
    evaluator = R1mAPEvaluator(
        num_query=num_query, device=dev if cfg.TPU.EVAL_ON_DEVICE else torch.device("cpu"),
        feat_norm=cfg.TEST.FEAT_NORM == "yes", reranking=cfg.TEST.RE_RANKING == "yes",
        scene_protocol=scene_protocol)
    if cached:
        n, bs = data.images.shape[0], cfg.TEST.IMS_PER_BATCH

        def batches():
            for start in range(0, n, bs):
                idx = torch.arange(start, min(start + bs, n), device=dev)
                images, pids, camids = data.batch(idx)
                yield images, pids, camids, data.viewids[idx], len(idx)
    else:
        def batches():
            order = np.arange(len(data.samples))
            for b, images, pids, camids, views in device_batches(
                    data, order, dev, drop_last=False, pad_last=True):
                yield images, pids, camids, views, b.valid
    for images, pids, camids, views, valid in batches():
        feat = eval_step(model, images, camids, mask, views, return_pattern)[:valid]
        evaluator.update(feat.cpu().numpy(), pids[:valid].cpu().numpy(),
                         camids[:valid].cpu().numpy(),
                         views[:valid].cpu().numpy() if scene_protocol else None)
    if rank_list_path is None and scene_protocol:
        rank_list_path = "re.txt"  # the reference always writes this for MSVR310
    return evaluator.compute(rank_list_path=rank_list_path)


def do_inference(cfg, model, data, num_query: int, return_pattern: int = 3,
                 rank_list_path: Optional[str] = None) -> Tuple[np.ndarray, float]:
    """run_eval with the reference's result lines (processor.py::do_inference);
    a data pipe is decoded into a DeviceCache first under TPU.DATA_CACHE
    "device"."""
    from ..data.device_cache import DeviceCache, build_device_cache

    if not isinstance(data, DeviceCache) and cfg.TPU.DATA_CACHE == "device":
        data = build_device_cache(data, next(model.parameters()).device, train=False)
    cmc, m_ap = run_eval(cfg, model, data, num_query, return_pattern, rank_list_path)
    logger.info("Validation Results")
    logger.info("mAP: %.1f%%", m_ap * 100)
    for r in (1, 5, 10):
        if len(cmc) >= r:
            logger.info("CMC curve, Rank-%d: %.1f%%", r, cmc[r - 1] * 100)
    return cmc, m_ap
