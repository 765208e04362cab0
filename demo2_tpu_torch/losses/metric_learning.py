"""The metric-learning losses (demo2_tpu/losses/metric_learning.py): the
margin heads' logits (Arcface, Cosface, AMSoftmax, CircleLoss), the
contrastive, cluster, range, hetero-center, tri-modal margin and supervised
contrastive losses.

No configuration trains with them (the reference's make_loss builds cross
entropy, triplet and center loss only); they are here so that a user of the
reference finds the whole loss surface.  Each is a plain function of its
inputs: a margin head takes its (num_classes, dim) class-weight matrix as an
argument.  The class-grouped losses take the PK sampler's static batch
structure, P ids of `k` contiguous samples, and reshape to (P, K, D): no
`unique()`, boolean indexing or per-class loop, so no result depends on
a host sync.  Everything runs in f32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(x.square().sum(dim, keepdim=True).sqrt(), min=eps)


def _cosine_logits(weight: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """cos(theta) between the normalized features (B, dim) and the normalized
    class weights (num_classes, dim)."""
    return _l2_normalize(feat.float()) @ _l2_normalize(weight.float()).t()


def _one_hot(labels: torch.Tensor, num_classes: int, dtype: torch.dtype) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).to(dtype)


def arcface_logits(weight: torch.Tensor, feat: torch.Tensor, labels: torch.Tensor,
                   s: float = 30.0, m: float = 0.30, easy_margin: bool = False,
                   ls_eps: float = 0.0) -> torch.Tensor:
    """Additive angular margin logits, s * cos(theta + m) on the target class
    (with the cos > th fallback to cosine - mm, and label smoothing)."""
    cosine = _cosine_logits(weight, feat)
    sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, min=0.0))
    phi = cosine * math.cos(m) - sine * math.sin(m)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        phi = torch.where(cosine > math.cos(math.pi - m), phi,
                          cosine - math.sin(math.pi - m) * m)
    one_hot = _one_hot(labels, weight.shape[0], cosine.dtype)
    if ls_eps > 0:
        one_hot = (1 - ls_eps) * one_hot + ls_eps / weight.shape[0]
    return s * (one_hot * phi + (1.0 - one_hot) * cosine)


def cosface_logits(weight: torch.Tensor, feat: torch.Tensor, labels: torch.Tensor,
                   s: float = 30.0, m: float = 0.30) -> torch.Tensor:
    """Large-margin cosine logits, s * (cos(theta) - m) on the target class."""
    cosine = _cosine_logits(weight, feat)
    return s * (cosine - _one_hot(labels, weight.shape[0], cosine.dtype) * m)


def am_softmax_logits(weight: torch.Tensor, feat: torch.Tensor, labels: torch.Tensor,
                      s: float = 30.0, m: float = 0.30) -> torch.Tensor:
    """Additive-margin softmax logits: cosface's, the weight taken as
    (num_classes, dim) like the other heads."""
    return cosface_logits(weight, feat, labels, s=s, m=m)


def circle_logits(weight: torch.Tensor, feat: torch.Tensor, labels: torch.Tensor,
                  s: float = 256.0, m: float = 0.25) -> torch.Tensor:
    """Circle-loss logits with self-paced linear weights alpha_p / alpha_n,
    which carry no gradient."""
    sim = _cosine_logits(weight, feat)
    sim_d = sim.detach()
    alpha_p = torch.clamp(-sim_d + 1 + m, min=0.0)
    alpha_n = torch.clamp(sim_d + m, min=0.0)
    s_p = s * alpha_p * (sim - (1 - m))
    s_n = s * alpha_n * (sim - m)
    one_hot = _one_hot(labels, weight.shape[0], sim.dtype)
    return one_hot * s_p + (1.0 - one_hot) * s_n


def contrastive_loss(feat: torch.Tensor, labels: torch.Tensor, margin: float = 0.3) -> torch.Tensor:
    """Pairwise contrastive loss over the inner-product similarities, as
    masked sums: a positive pair with sim < 1 adds 1 - sim, a negative pair
    with sim > margin adds sim."""
    feat = feat.float()
    sim = feat @ feat.t()
    same = labels[:, None] == labels[None, :]
    pos = same & (sim < 1.0)
    neg = (~same) & (sim > margin)
    zero = torch.zeros((), dtype=sim.dtype, device=sim.device)
    per_row = (torch.where(pos, 1.0 - sim, zero).sum(1) + torch.where(neg, sim, zero).sum(1))
    return per_row.mean()


def _pk_view(feat: torch.Tensor, k: int) -> torch.Tensor:
    """(P*K, D) -> (P, K, D) under the PK sampler's contiguous groups."""
    n, d = feat.shape
    assert n % k == 0, f"batch {n} not divisible by instances-per-id {k}"
    return feat.reshape(n // k, k, d)


def _pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Euclidean distances sqrt(max(|x|^2 + |y|^2 - 2 x.y, 1e-12)), batched
    over the leading axes: (..., M, D), (..., N, D) -> (..., M, N)."""
    xx = x.square().sum(-1)[..., :, None]
    yy = y.square().sum(-1)[..., None, :]
    sq = xx + yy - 2.0 * (x @ y.transpose(-1, -2))
    return torch.sqrt(torch.clamp(sq, min=1e-12))


def cluster_loss(feat: torch.Tensor, k: int,
                 margin: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per class: its center (the mean of its K features), intra = the
    largest center-to-member distance, inter = the distance to the nearest
    other center; (mean(relu(intra - inter + margin)), intra, inter)."""
    g = _pk_view(feat.float(), k)
    centers = g.mean(1)
    intra = _pairwise_dist(centers[:, None, :], g)[:, 0, :].amax(1)
    cdist = _pairwise_dist(centers, centers)
    p = centers.shape[0]
    eye = torch.eye(p, dtype=torch.bool, device=feat.device)
    inter = torch.where(eye, torch.full_like(cdist, math.inf), cdist).amin(1)
    return F.relu(intra - inter + margin).mean(), intra, inter


def range_loss(feat: torch.Tensor, k_instances: int, top_k: int = 2, margin: float = 0.1,
               alpha: float = 0.5,
               beta: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """alpha * intra + beta * inter.  Intra: over the classes, the sum of the
    harmonic means of each class's top_k largest pairwise distances (every
    other entry of the sorted K*K distances from the end: each pair is there
    twice).  Inter: relu(margin - the smallest distance between two centers),
    entry P of the sorted center distances (the first P are the
    self-distances).  Returns (loss, intra, inter)."""
    g = _pk_view(feat.float(), k_instances)
    p = g.shape[0]
    d = _pairwise_dist(g, g).reshape(p, -1)
    topk = torch.sort(d, dim=1).values[:, -top_k * 2::2]
    intra = (top_k / (1.0 / topk).sum(1)).sum()
    centers = g.mean(1)
    cflat = torch.sort(_pairwise_dist(centers, centers).reshape(-1)).values
    inter = F.relu(margin - cflat[p])
    return alpha * intra + beta * inter, intra, inter


def _class_centers(feat: torch.Tensor, k: int) -> torch.Tensor:
    return _pk_view(feat.float(), k).mean(1)


def hetero_loss(feat1: torch.Tensor, feat2: torch.Tensor, k: int, margin: float = 0.1,
                dist_type: str = "l2") -> torch.Tensor:
    """The sum over classes of the distance between the two modalities'
    class centers: 'l2' the squared error, 'l1' the mean absolute error,
    'cos' relu(1 - cos).  `margin` is unused, as in the reference."""
    del margin
    c1, c2 = _class_centers(feat1, k), _class_centers(feat2, k)
    if dist_type == "l2":
        per = (c1 - c2).square().sum(1)
    elif dist_type == "l1":
        per = (c1 - c2).abs().mean(1)
    elif dist_type == "cos":
        per = F.relu(1.0 - (_l2_normalize(c1) * _l2_normalize(c2)).sum(1))
    else:
        raise ValueError(f"unknown dist_type {dist_type!r}")
    return per.sum()


def multimodal_margin_loss(feat1: torch.Tensor, feat2: torch.Tensor, feat3: torch.Tensor,
                           k: int, margin: float = 3.0, dist_type: str = "l2") -> torch.Tensor:
    """Per class, the largest of the three |margin - dist(center_i,
    center_j)| between the modalities' class centers ('l2' squared error,
    'l1' mean absolute error); summed over the classes."""
    c = [_class_centers(f, k) for f in (feat1, feat2, feat3)]

    def dist(a, b):
        if dist_type == "l2":
            return (a - b).square().sum(1)
        if dist_type == "l1":
            return (a - b).abs().mean(1)
        raise ValueError(f"unknown dist_type {dist_type!r}")

    devs = torch.stack([(margin - dist(c[0], c[1])).abs(), (margin - dist(c[1], c[2])).abs(),
                        (margin - dist(c[0], c[2])).abs()])
    return devs.amax(0).sum()


def supcon_loss(text_features: torch.Tensor, image_features: torch.Tensor,
                t_labels: torch.Tensor, i_labels: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """Supervised contrastive loss between two feature sets: a row's
    log-softmax (its maximum subtracted, without gradient) averaged over its
    positives.  A row with no positive adds 0 (the reference divides by 0)."""
    t = text_features.float()
    v = image_features.float()
    mask = (t_labels[:, None] == i_labels[None, :]).float()
    logits = (t @ v.t()) / temperature
    logits = logits - logits.amax(1, keepdim=True).detach()
    log_prob = logits - torch.log(torch.exp(logits).sum(1, keepdim=True))
    mean_log_prob_pos = (mask * log_prob).sum(1) / torch.clamp(mask.sum(1), min=1.0)
    return -mean_log_prob_pos.mean()
