"""Re-ID retrieval metrics, vectorised on the device (demo2_tpu/utils/metrics.py).

`cmc_map` is the port of `cmc_map_device`: ranking, same-id + same-camera
(or same-scene) gallery removal, CMC and AP as mask arithmetic, no
per-query loop.  Re-ranking waits for its kernel (ROADMAP.md, port queue).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .. import not_ported


def euclidean_distance(qf: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance matrix, expanded: |q|^2 + |g|^2 - 2 q.g."""
    qf = qf.float()
    gf = gf.float()
    qq = qf.square().sum(1, keepdim=True)
    gg = gf.square().sum(1, keepdim=True).t()
    return qq + gg - (2.0 * qf) @ gf.t()


def cmc_map(distmat: torch.Tensor, q_pids: torch.Tensor, g_pids: torch.Tensor,
            q_filter_ids: torch.Tensor, g_filter_ids: torch.Tensor,
            max_rank: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """CMC curve (max_rank,) and mAP; gallery entries with the query's id
    AND filter id (camera, or scene for MSVR310) are discarded."""
    num_g = distmat.shape[1]
    max_rank = min(max_rank, num_g)
    order = torch.argsort(distmat, dim=1, stable=True)
    matches = g_pids[order] == q_pids[:, None]
    keep = ~(matches & (g_filter_ids[order] == q_filter_ids[:, None]))
    kept_pos = keep.cumsum(1)  # 1-based position among kept entries
    mk = matches & keep
    valid = mk.any(1)
    num_valid = valid.float().sum().clamp(min=1)

    first_pos = torch.where(mk, kept_pos, num_g + 1).min(1).values
    ranks = torch.arange(1, max_rank + 1, device=distmat.device)
    cmc_hits = (first_pos[:, None] <= ranks[None, :]) & valid[:, None]
    cmc = cmc_hits.float().sum(0) / num_valid

    prec = torch.where(mk, mk.cumsum(1) / kept_pos.clamp(min=1), 0.0)
    ap = prec.sum(1) / mk.sum(1).clamp(min=1)
    mean_ap = torch.where(valid, ap, 0.0).sum() / num_valid
    return cmc, mean_ap


@dataclasses.dataclass
class R1mAPEvaluator:
    """Feature accumulator; compute() ranks on `device` (reset / update /
    compute protocol of the reference's R1_mAP_eval)."""

    num_query: int
    device: torch.device
    feat_norm: bool = True
    reranking: bool = False

    def __post_init__(self):
        if self.reranking:
            raise not_ported("re-ranking", "kernel 12 with re-ranking")
        self.reset()

    def reset(self):
        self.feats: List[np.ndarray] = []
        self.pids: List[np.ndarray] = []
        self.camids: List[np.ndarray] = []

    def update(self, feat, pid, camid):
        self.feats.append(np.asarray(feat))
        self.pids.append(np.asarray(pid))
        self.camids.append(np.asarray(camid))

    def compute(self) -> Tuple[np.ndarray, float]:
        """(CMC to rank 50, mAP), same-id + same-camera gallery entries
        removed (the market1501 protocol; MSVR310's scene protocol comes with
        the eval entry points)."""
        pids = np.concatenate(self.pids)
        filt = np.concatenate(self.camids)
        nq = self.num_query
        if not np.any(np.isin(pids[:nq], pids[nq:])):
            raise AssertionError(
                "all query identities do not appear in gallery — check num_query / the "
                "query-gallery split"
            )
        f = torch.from_numpy(np.concatenate(self.feats, axis=0)).to(self.device)
        if self.feat_norm:
            f = f / f.norm(dim=1, keepdim=True).clamp(min=1e-12)
        distmat = euclidean_distance(f[:nq], f[nq:])
        as_dev = lambda a: torch.from_numpy(np.asarray(a)).to(self.device)
        cmc, mean_ap = cmc_map(distmat, as_dev(pids[:nq]), as_dev(pids[nq:]),
                               as_dev(filt[:nq]), as_dev(filt[nq:]))
        return cmc.cpu().numpy(), float(mean_ap)
