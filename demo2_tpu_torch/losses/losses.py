"""Training losses (demo2_tpu/losses/losses.py): label-smoothed ID loss and
batch-hard triplet, combined per branch by `make_loss_fn` and weighted by
`branch_weights`.

All reductions run in f32.  The batch-hard mining uses masked max / min, as
the JAX package does: with the PK sampler's guarantee that every anchor has a
positive and a negative, that equals the reference's boolean indexing.
Center loss and DeMo_Parallel's branch weights are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from .. import not_ported
from ..config.defaults import Config


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def cross_entropy_label_smooth(logits: torch.Tensor, labels: torch.Tensor,
                               epsilon: float = 0.1) -> torch.Tensor:
    """CrossEntropyLabelSmooth: targets (1 - eps) one-hot + eps / classes."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).float()
    targets = (1.0 - epsilon) * onehot + epsilon / num_classes
    return (-targets * logp).sum(-1).mean()


def euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(max(|x|^2 + |y|^2 - 2 x.y, 1e-12)) in f32
    (metric_learning.py::_pairwise_dist's numerics)."""
    x, y = x.float(), y.float()
    xx = x.square().sum(-1)[:, None]
    yy = y.square().sum(-1)[None, :]
    return torch.sqrt(torch.clamp(xx + yy - 2.0 * (x @ y.t()), min=1e-12))


def batch_hard_triplet_loss(feat: torch.Tensor, labels: torch.Tensor,
                            margin: Optional[float] = None) -> torch.Tensor:
    """Batch-hard triplet; soft margin (softplus) when margin is None, else
    MarginRankingLoss: mean(relu(ap - an + margin))."""
    dist = euclidean_dist(feat, feat)
    same = labels[:, None] == labels[None, :]
    dist_ap = torch.where(same, dist, torch.full_like(dist, -1e30)).amax(1)
    dist_an = torch.where(same, torch.full_like(dist, 1e30), dist).amin(1)
    if margin is not None:
        return F.relu(dist_ap - dist_an + margin).mean()
    return F.softplus(-(dist_an - dist_ap)).mean()


def make_loss_fn(cfg: Config, num_classes: int) -> Callable:
    """The per-branch loss (logits, feat, target) -> scalar: cross-entropy
    alone for DATALOADER.SAMPLER='softmax', else ID_W * (label-smoothed)
    cross-entropy + TRI_W * batch-hard triplet."""
    if "center" in cfg.MODEL.METRIC_LOSS_TYPE:
        raise not_ported("center loss", "the rest of the modules (center loss)")
    sampler = cfg.DATALOADER.SAMPLER
    if sampler == "softmax":
        return lambda logits, feat, target: softmax_cross_entropy(logits, target)
    if sampler != "softmax_triplet":
        raise ValueError(f"DATALOADER.SAMPLER must be softmax|softmax_triplet, got {sampler!r}")
    use_smooth = cfg.MODEL.IF_LABELSMOOTH == "on"
    margin = None if cfg.MODEL.NO_MARGIN else cfg.SOLVER.MARGIN
    id_w, tri_w = cfg.MODEL.ID_LOSS_WEIGHT, cfg.MODEL.TRIPLET_LOSS_WEIGHT

    def loss_fn(logits, feat, target):
        ce = cross_entropy_label_smooth if use_smooth else softmax_cross_entropy
        return id_w * ce(logits, target) + tri_w * batch_hard_triplet_loss(feat, target, margin)

    return loss_fn


def branch_weights(cfg: Config, branch_names: Iterable[str]) -> Dict[str, float]:
    """The reference engine's weighting: the FIRST (score, feat) pair is
    multiplied by SDTPS_LOSS_WEIGHT whenever USE_SDTPS is set, the dgaf pair
    of the SDTPS + DGAF branch included (losses.py:174-176)."""
    if cfg.MODEL.ARCH == "DeMo_Parallel":
        raise not_ported("DeMo_Parallel's branch weights", "other DeMo branches and assemblies")
    names = list(branch_names)
    w = {n: 1.0 for n in names}
    if cfg.MODEL.USE_SDTPS and names:
        w[names[0]] = cfg.MODEL.SDTPS_LOSS_WEIGHT
    return w
