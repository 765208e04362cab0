"""Training losses (demo2_tpu/losses/losses.py): label-smoothed ID loss and
batch-hard triplet, combined per branch by `make_loss_fn` and weighted by
`branch_weights`, and the center loss that engine/train.py adds on the first
branch's feature when "center" is in MODEL.METRIC_LOSS_TYPE.

All reductions run in f32.  The batch-hard mining uses masked max / min, as
the JAX package does: with the PK sampler's guarantee that every anchor has a
positive and a negative, that equals the reference's boolean indexing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from ..config.defaults import Config
from ..parallel.collectives import own_rows


F32_TINY = 2.0 ** -126  # the smallest normal f32 (and bf16)


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
    """sqrt(max(|x|^2 + |y|^2 - 2 x.y, 1e-12)) in f32: metric_learning.py's
    _pairwise_dist, the one definition of these numerics."""
    from .metric_learning import _pairwise_dist

    return _pairwise_dist(x.float(), y.float())


def batch_hard_triplet_loss(feat: torch.Tensor, labels: torch.Tensor,
                            margin: Optional[float] = None,
                            normalize_feature: bool = False) -> torch.Tensor:
    """Batch-hard triplet; soft margin (softplus) when margin is None, else
    MarginRankingLoss: mean(relu(ap - an + margin)).  `normalize_feature`
    divides each row by its norm (+ 1e-12) first; the max before the sqrt
    keeps the backward finite at an all-zero row.  Its floor is f32's
    smallest normal: the JAX package's 1e-60 rounds to 0 in f32, which gives
    that row a NaN gradient there; the forward is the same."""
    if normalize_feature:
        n2 = feat.square().sum(-1, keepdim=True)
        feat = feat / (torch.sqrt(torch.clamp(n2, min=F32_TINY)) + 1e-12)
    dist = euclidean_dist(feat, feat)
    same = labels[:, None] == labels[None, :]
    dist_ap = torch.where(same, dist, torch.full_like(dist, -1e30)).amax(1)
    dist_an = torch.where(same, torch.full_like(dist, 1e30), dist).amin(1)
    if margin is not None:
        return F.relu(dist_ap - dist_an + margin).mean()
    return F.softplus(-(dist_an - dist_ap)).mean()


@dataclass
class CenterLossState:
    """The learnable class centers (num_classes, feat_dim), f32."""

    centers: torch.Tensor

    @staticmethod
    def create(generator: torch.Generator, num_classes: int, feat_dim: int = 2048,
               device: Optional[torch.device] = None) -> "CenterLossState":
        """Standard normal centers drawn from `generator` (on its device),
        then moved to `device`."""
        c = torch.randn((num_classes, feat_dim), generator=generator,
                        device=generator.device, dtype=torch.float32)
        return CenterLossState(c.to(device or c.device))


def center_loss(centers: torch.Tensor, feat: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of each feature's squared distance to its
    class center, clamped to [1e-12, 1e12].  Under data parallelism `feat`
    and `labels` are the global batch's, and the centers' gradient is taken
    from this rank's rows only (parallel/collectives.py::own_rows): the sum
    over the ranks is then the one-process gradient."""
    c = own_rows(centers[labels.long()]).float()
    d = (feat.float() - c).square().sum(-1)
    return torch.clamp(d, 1e-12, 1e12).mean()


def make_loss_fn(cfg: Config, num_classes: int) -> Callable:
    """The per-branch loss (logits, feat, target) -> scalar: cross-entropy
    alone for DATALOADER.SAMPLER='softmax', else ID_W * (label-smoothed)
    cross-entropy + TRI_W * batch-hard triplet.  The center loss is not a
    branch's: engine/train.py::loss_and_grads adds it."""
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
    of the SDTPS + DGAF branch included (losses.py:174-176).  DeMo_Parallel
    weighs each branch family by its SDTPS / DGAF / FUSED_LOSS_WEIGHT; with
    MODEL.PARALLEL_LOSS_PARITY it takes the reference engine's rule, where
    only the first pair, sdtps_rgb, carries SDTPS_LOSS_WEIGHT."""
    names = list(branch_names)
    m = cfg.MODEL
    if m.ARCH == "DeMo_Parallel":
        if m.PARALLEL_LOSS_PARITY:
            w = {n: 1.0 for n in names}
            if m.USE_SDTPS and "sdtps_rgb" in w:
                w["sdtps_rgb"] = m.SDTPS_LOSS_WEIGHT
            return w
        family = {"sdtps": m.SDTPS_LOSS_WEIGHT, "dgaf": m.DGAF_LOSS_WEIGHT,
                  "fused": m.FUSED_LOSS_WEIGHT}
        return {n: family.get(n.split("_")[0], 1.0) for n in names}
    w = {n: 1.0 for n in names}
    if cfg.MODEL.USE_SDTPS and names:
        w[names[0]] = cfg.MODEL.SDTPS_LOSS_WEIGHT
    return w
