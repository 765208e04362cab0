"""SDTPS's "complete" / "fixed" variant (demo2_tpu/models/sdtps_variants.py::
SDTPSComplete), selected by MODEL.SDTPS_VARIANT.

Against the active models/sdtps.py: a multi-head cross-modal attention whose
per-head softmax over the patches is gated by sigmoid(cos * scale_h +
bias_h) and averaged over the heads; scores min-max normalised per row and
averaged over the three guides; a hard top-k mask, K = ceil(N * ratio),
with an optional Gumbel-softmax straight-through estimator in training,
whose noise draws from the caller's torch.Generator (flax's 'gumbel' rng in
the JAX package: the two give different draws from one seed).  The output
keeps its shape: the masked patches are zeroed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.linear import cached_cast, make_param, ones_init, uniform_init, zeros_init
from ..parallel.collectives import batch_rand
from .sdtps import GUIDE_ORDER, l2_normalize


class SDTPSComplete(nn.Module):
    def __init__(self, embed_dim: int, *, num_heads: int, sparse_ratio: float,
                 use_gumbel: bool, gumbel_tau: float, use_cross_attn: bool,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator):
        super().__init__()
        c, m = embed_dim, 3
        self.num_heads = num_heads
        self.sparse_ratio = sparse_ratio
        self.use_gumbel = use_gumbel
        self.gumbel_tau = gumbel_tau
        self.use_cross_attn = use_cross_attn
        self.dtype = dtype
        if use_cross_attn:
            kw = dict(generator=generator, device=device)
            # flax xavier_uniform on (3, 3, C, C): fan_in = fan_out = 9 C.
            xavier = uniform_init(math.sqrt(6.0 / (2 * m * m * c)))
            for name in ("q", "k"):
                setattr(self, f"{name}_proj_kernel", make_param((m, m, c, c), xavier, **kw))
                setattr(self, f"{name}_proj_bias", make_param((m, m, c), zeros_init, **kw))
            # The gates start at scale = bias = 0.5.
            half = lambda shape, g: 0.5 * ones_init(shape, g)
            self.gate_scale = make_param((m, m, num_heads), half, **kw)
            self.gate_bias = make_param((m, m, num_heads), half, **kw)

    def forward(self, patches: torch.Tensor, globals_: torch.Tensor, train: bool = False,
                generator: torch.Generator = None):
        """patches (3, B, N, C), globals_ (3, B, C) -> (masked patches, mask (3, B, N))."""
        m, b, n, c = patches.shape
        h = self.num_heads
        d = c // h
        cos = torch.einsum("mbnc,gbc->mgbn", l2_normalize(patches.float()),
                           l2_normalize(globals_.float()))  # (3, 3, B, N)

        if self.use_cross_attn:
            cd = self.dtype
            wq, bq, wk, bk = (cached_cast(self, name, cd) for name in (
                "q_proj_kernel", "q_proj_bias", "k_proj_kernel", "k_proj_bias"))
            # q[m, g] projects guide g's global, k[m, g] modality m's patches;
            # the heads split the projected channels.
            q = (torch.einsum("gbc,mgcd->mgbd", globals_.to(cd), wq)
                 + bq[:, :, None, :]).reshape(m, m, b, h, d)
            k = (torch.einsum("mbnc,mgcd->mgbnd", patches.to(cd), wk)
                 + bk[:, :, None, None, :]).reshape(m, m, b, n, h, d)
            logits = torch.einsum("mgbhd,mgbnhd->mgbhn", q.float(), k.float()) * d ** -0.5
            attn = torch.softmax(logits, dim=-1)  # (3, 3, B, H, N)
            gate = torch.sigmoid(cos[:, :, :, None, :] * self.gate_scale[:, :, None, :, None]
                                 + self.gate_bias[:, :, None, :, None])
            scores = (attn * gate).mean(3)  # (3, 3, B, N)
        else:
            scores = cos

        guide = torch.tensor(GUIDE_ORDER, device=patches.device)
        ordered = scores[torch.arange(m, device=patches.device)[:, None], guide]
        smin = ordered.amin(-1, keepdim=True)
        smax = ordered.amax(-1, keepdim=True)
        score = ((ordered - smin) / (smax - smin + 1e-8)).mean(1)  # (3, B, N)

        # The top K by score, ties to the lower index (a stable sort).
        num_keep = max(1, math.ceil(n * self.sparse_ratio))
        order = torch.argsort(-score, dim=-1, stable=True)
        hard = torch.zeros_like(score).scatter_(-1, order[..., :num_keep], 1.0)
        if self.use_gumbel and train:
            u = batch_rand(score.shape, generator=generator, device=score.device,
                           batch_axis=1)
            noise = -torch.log(-torch.log(u + 1e-9) + 1e-9)
            soft = torch.softmax((score + noise) / self.gumbel_tau, dim=-1)
            mask = hard + (soft - soft.detach())  # straight through
        else:
            mask = hard
        return patches * mask[..., None].to(patches.dtype), mask
