"""Re-ID retrieval metrics, vectorised on the device (demo2_tpu/utils/metrics.py).

`cmc_map` is the port of `cmc_map_device`: ranking, same-id + same-camera
(or same-scene) gallery removal, CMC and AP as mask arithmetic, no
per-query loop.  `R1mAPEvaluator` ranks by the euclidean distance or, with
`reranking`, by utils/reranking.py::re_ranking, under the market1501 (camera)
or the MSVR310 (scene) protocol.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch


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
    compute protocol of the reference's R1_mAP_eval, and of R1_mAP for
    MSVR310)."""

    num_query: int
    device: torch.device
    feat_norm: bool = True
    reranking: bool = False
    scene_protocol: bool = False  # MSVR310: filter by scene instead of camera

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.feats: List[np.ndarray] = []
        self.pids: List[np.ndarray] = []
        self.camids: List[np.ndarray] = []
        self.sceneids: List[np.ndarray] = []

    def update(self, feat, pid, camid, sceneid=None):
        self.feats.append(np.asarray(feat))
        self.pids.append(np.asarray(pid))
        self.camids.append(np.asarray(camid))
        if sceneid is not None:
            self.sceneids.append(np.asarray(sceneid))

    def compute(self, rank_list_path: Optional[str] = None) -> Tuple[np.ndarray, float]:
        """(CMC to rank 50, mAP); gallery entries with the query's id and
        camera (scene under `scene_protocol`) are removed.  With
        `rank_list_path` the per-query rank list is written there."""
        pids = np.concatenate(self.pids)
        camids = np.concatenate(self.camids)
        scenes = np.concatenate(self.sceneids) if self.sceneids else None
        if self.scene_protocol and scenes is None:
            raise ValueError("the scene protocol needs update(..., sceneid=...)")
        nq = self.num_query
        # A split where no query identity appears in the gallery is broken,
        # not a 0-mAP model.  Checked before the distance pass: the metadata
        # alone decides it, and re-ranking at dataset scale is the costly part.
        if not np.any(np.isin(pids[:nq], pids[nq:])):
            raise AssertionError(
                "all query identities do not appear in gallery — check num_query / the "
                "query-gallery split"
            )
        f = torch.from_numpy(np.concatenate(self.feats, axis=0)).to(self.device)
        if self.feat_norm:
            f = f / f.norm(dim=1, keepdim=True).clamp(min=1e-12)
        if self.reranking:
            from .reranking import re_ranking

            distmat = re_ranking(f[:nq], f[nq:], k1=50, k2=15, lambda_value=0.3)
        else:
            distmat = euclidean_distance(f[:nq], f[nq:])
        if rank_list_path is not None:
            from ..visualize.rank_list import save_rank_list

            save_rank_list(
                distmat.cpu().numpy(), pids[:nq], pids[nq:], camids[:nq], camids[nq:],
                scenes[:nq] if scenes is not None else None,
                scenes[nq:] if scenes is not None else None,
                path=rank_list_path,
            )
        filt = scenes if self.scene_protocol else camids
        as_dev = lambda a: torch.from_numpy(np.asarray(a)).to(self.device)
        cmc, mean_ap = cmc_map(distmat, as_dev(pids[:nq]), as_dev(pids[nq:]),
                               as_dev(filt[:nq]), as_dev(filt[nq:]))
        return cmc.cpu().numpy(), float(mean_ap)
