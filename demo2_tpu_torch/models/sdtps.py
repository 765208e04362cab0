"""SDTPS token scoring and soft masking (demo2_tpu/models/sdtps.py).

All 9 (modality, guide) pairs are scored by stacked einsums over parameters
with leading (3, 3) axes; the quantile threshold + sigmoid soft mask keeps
shapes static.  SDTPS_CROSS_ATTN_TYPE='attention' adds the projected
cross-attention logits to the cosine scores; 'cosine' uses the cosines alone.  With
`share_cross_attn_weights` (MODEL.SDTPS_SHARE_CROSS_ATTN) each modality keeps
one projection for its three guides: the parameters are (3, 1, C, C) and
broadcast to (3, 3, C, C).
In training the modality-weight MLPs' dropout draws from the caller's
torch.Generator (flax's 'dropout' rng in the JAX package: the two give
different draws from one seed).
With `use_soft_masking=False` (sdtps.py:167-179; no configuration selects
it, in either package) the mask is hard: the ceil(N * sparse_ratio) top
scores by a double argsort, ties to the lower index; with `use_gumbel` in
training its gradient is a Gumbel-noised sigmoid's (straight through:
hard + (soft - soft.detach())), the noise drawn from the caller's generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.linear import Linear, cached_cast, make_param, uniform_init, zeros_init
from ..ops.norm import LayerNorm

COSINE_TAU = 0.3     # temperature of the cosine scores in the logits
SOFT_MASK_TAU = 0.3  # temperature of the sigmoid soft mask

# Per-modality guide order (self, m2, m3): RGB against (RGB, NIR, TIR), NIR
# against (NIR, RGB, TIR), TIR against (TIR, RGB, NIR).
GUIDE_ORDER = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n2 = x.square().sum(dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(n2, min=eps * eps))


def _xavier_half(fan_in: int, fan_out: int):
    """flax variance_scaling(0.25, 'fan_avg', 'uniform')."""
    return uniform_init(math.sqrt(3.0 * 0.25 / ((fan_in + fan_out) / 2.0)))


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax nn.Dropout in training: keep with probability 1 - rate, scale
    the kept values by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class ModalWeightMLP(nn.Module):
    """Sample-adaptive modality-weight MLP: (B, 3C) -> (B, 3) logits."""

    def __init__(self, in_features: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc0 = Linear(in_features, 256, weight_init=_xavier_half(in_features, 256), **kw)
        self.ln = LayerNorm(256, device=device)
        self.fc1 = Linear(256, 64, weight_init=_xavier_half(256, 64), **kw)
        # Zero-initialised so that the initial modality weights are uniform.
        self.fc2 = Linear(64, 3, weight_init=zeros_init, **kw)

    def forward(self, g: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        x = F.gelu(self.ln(self.fc0(g)))
        if train:
            x = dropout(x, self.dropout, generator)
        x = F.gelu(self.fc1(x))
        return self.fc2(x)


class MultiModalSDTPS(nn.Module):
    def __init__(self, embed_dim: int, *, sparse_ratio: float, use_cross_attn: bool,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator,
                 share_cross_attn_weights: bool = False, use_soft_masking: bool = True,
                 use_gumbel: bool = False, gumbel_tau: float = 1.0):
        super().__init__()
        c, m = embed_dim, 3
        self.sparse_ratio = sparse_ratio
        self.use_soft_masking = use_soft_masking
        self.use_gumbel = use_gumbel
        self.gumbel_tau = gumbel_tau
        self.use_cross_attn = use_cross_attn
        self.dtype = dtype
        if use_cross_attn:
            # flax xavier_uniform on (3, 3, C, C) or (3, 1, C, C): the leading
            # axes count as receptive field, so fan_in = fan_out = 9 C or 3 C.
            lead = (m, 1) if share_cross_attn_weights else (m, m)
            xavier = uniform_init(math.sqrt(6.0 / (2 * lead[0] * lead[1] * c)))
            for name in ("q", "k"):
                setattr(self, f"{name}_proj_kernel",
                        make_param((*lead, c, c), xavier, generator=generator, device=device))
                setattr(self, f"{name}_proj_bias",
                        make_param((*lead, c), zeros_init, generator=generator, device=device))
        self.modal_weight_mlp = nn.ModuleList(
            ModalWeightMLP(m * c, dtype=dtype, device=device, generator=generator)
            for _ in range(m)
        )

    @staticmethod
    def _normalize_score(s: torch.Tensor) -> torch.Tensor:
        """Z-score over tokens (unbiased std, eps inside the sqrt) + sigmoid."""
        n = s.shape[-1]
        mean = s.mean(-1, keepdim=True)
        var = (s - mean).square().sum(-1, keepdim=True) / max(n - 1, 1)
        return torch.sigmoid((s - mean) / (torch.sqrt(var + 1e-20) + 1e-5))

    def forward(self, patches: torch.Tensor, globals_: torch.Tensor, train: bool = False,
                generator: torch.Generator = None):
        """patches (3, B, N, C), globals_ (3, B, C) -> (enhanced patches, mask (3, B, N))."""
        m, b, n, c = patches.shape
        pn = l2_normalize(patches.float())
        gn = l2_normalize(globals_.float())
        cos = torch.einsum("mbnc,gbc->mgbn", pn, gn)  # (3, 3, B, N)

        if self.use_cross_attn:
            cd = self.dtype
            wq, bq, wk, bk = (cached_cast(self, name, cd) for name in (
                "q_proj_kernel", "q_proj_bias", "k_proj_kernel", "k_proj_bias"))
            wq, bq, wk, bk = (w.expand(m, m, *w.shape[2:]) for w in (wq, bq, wk, bk))
            # q[m, g] projects guide g's global; k[m, g] projects modality m's patches.
            q = torch.einsum("gbc,mgcd->mgbd", globals_.to(cd), wq) + bq[:, :, None, :]
            k = torch.einsum("mbnc,mgcd->mgbnd", patches.to(cd), wk) + bk[:, :, None, None, :]
            logits = torch.einsum("mgbd,mgbnd->mgbn", q.float(), k.float()) * (c ** -0.5)
            scores = torch.softmax(logits + cos / COSINE_TAU, dim=-1)
        else:
            scores = cos

        guide = torch.tensor(GUIDE_ORDER, device=patches.device)
        ordered = scores[torch.arange(m, device=patches.device)[:, None], guide]  # (3, 3, B, N)
        s_norm = self._normalize_score(ordered)

        gcat = torch.cat([globals_[0], globals_[1], globals_[2]], dim=-1)
        weights = torch.stack(
            [torch.softmax(mlp(gcat, train, generator).float(), dim=-1)
             for mlp in self.modal_weight_mlp]
        )  # (3, B, 3)
        score = torch.einsum("mjbn,mbj->mbn", s_norm, weights)

        if self.use_soft_masking:
            thr = torch.quantile(score, 1.0 - self.sparse_ratio, dim=-1, keepdim=True)
            mask = torch.sigmoid((score - thr) / SOFT_MASK_TAU)
        else:
            mask = self._hard_mask(score, train, generator)
        return patches * mask[..., None].to(patches.dtype), mask

    def _hard_mask(self, score: torch.Tensor, train: bool, generator) -> torch.Tensor:
        """1 on the ceil(N * sparse_ratio) top scores of each row (ranked by a
        double argsort, ties to the lower index), else 0; with Gumbel in
        training the straight-through estimator around it."""
        num_keep = max(1, math.ceil(score.shape[-1] * self.sparse_ratio))
        ranks = torch.argsort(torch.argsort(-score, dim=-1, stable=True), dim=-1)
        hard = (ranks < num_keep).float()
        if not (self.use_gumbel and train):
            return hard
        u = torch.rand(score.shape, generator=generator, device=score.device)
        noise = -torch.log(-torch.log(u + 1e-9) + 1e-9)
        soft = torch.sigmoid((score + noise - 0.5) / self.gumbel_tau)
        return hard + (soft - soft.detach())
