"""HDM (hierarchical decoupling) + ATMoE (attention-triggered mixture of
experts): DeMo's own fusion (demo2_tpu/models/hdm_atmoe.py: HDM, ATMoE,
GeneralFusion).

HDM attends a learned query per token set over the subsets {R}, {N}, {T},
{RN}, {RT}, {NT} and {RNT} of the three modalities' [global; patches]
segments, with 7 stacked attention projections.  It keeps the JAX package's
formulation:
  * k is never formed: each set's query is a constant vector, so
    q^T (W_k x + b_k) = (W_k^T q)^T x + q^T b_k, and u = W_k^T q is one thin
    (C, 4h) projection per modality (a modality belongs to 4 of the 7 sets);
  * v is projected modality-major, one (C, 4C) product per modality;
  * each set takes one softmax over its members' logits jointly, which is
    the softmax over the concatenated subset.
The logits are f32 (the operands cast to f32 first), the products in the
compute dtype.  ATMoE gates 7 dense experts per head chunk with an attention
gate; its experts are one (head, expert, d, d) product and one flattened
BatchNorm.  Both BatchNorms use batch statistics in training and update
their running statistics.  Dropout on HDM's probabilities draws from the
caller's torch.Generator (flax's 'dropout' rng in the JAX package: the two
give different draws from one seed).  No kernel of csrc/ runs here: the JAX
package computes these products outside any Pallas kernel too.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.activations import quick_gelu
from ..ops.linear import Init, Linear, cached_cast, make_param, normal_init, uniform_init
from ..ops.linear import zeros_init
from ..ops.norm import TorchBatchNorm
from .sdtps import dropout

NUM_SETS = 7
# Membership of each modality segment (R, N, T) in each of the 7 sets.
SET_MEMBERSHIP = np.array(
    [
        [1, 0, 0],  # R
        [0, 1, 0],  # N
        [0, 0, 1],  # T
        [1, 1, 0],  # RN
        [1, 0, 1],  # RT
        [0, 1, 1],  # NT
        [1, 1, 1],  # RNT
    ],
    dtype=np.float32,
)
# The 12 (set, member modality) pairs, set-major and grouped by the set's
# cardinality; within a set in modality order (R, N, T).
PAIR_SET = np.array([0, 1, 2, 3, 3, 4, 4, 5, 5, 6, 6, 6])
PAIR_MOD = np.array([0, 1, 2, 0, 1, 0, 2, 1, 2, 0, 1, 2])
CARD_GROUPS = ((0, 3, 1), (3, 9, 2), (9, 12, 3))  # (pair_start, pair_end, card)
# The same 12 pairs modality-major: the 4 sets of each modality.
MOD_SETS = np.array([[0, 3, 4, 6], [1, 3, 5, 6], [2, 4, 5, 6]])
# Set-major pair i is modality-major pair MM_TO_SET[i]; SET_TO_MM inverts it.
MM_TO_SET = np.array([0, 4, 8, 1, 5, 2, 9, 6, 10, 3, 7, 11])
SET_TO_MM = np.argsort(MM_TO_SET)
# The set of each modality-major pair.
MM_SET_IDS = np.array([0, 3, 4, 6, 1, 3, 5, 6, 2, 4, 5, 6])


def _xavier(shape) -> Init:
    """flax xavier_uniform: the axes before the last two count as receptive
    field in both fans."""
    rf = math.prod(shape[:-2])
    return uniform_init(math.sqrt(6.0 / (rf * (shape[-2] + shape[-1]))))


class HDM(nn.Module):
    """(3, B, N, C) patches and (3, B, C) globals -> (7, B, C) set features."""

    def __init__(self, feat_dim: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator, dropout: float = 0.1):
        super().__init__()
        c = feat_dim
        self.dtype = dtype
        self.dropout = dropout
        kw = dict(generator=generator, device=device)
        # Two scales: the tokens' init takes feat_dim ** -0.5, the logits the
        # per-head d ** -0.5 (they coincide only at feat_dim = 64, h = 1).
        self.set_tokens = make_param((NUM_SETS, c), normal_init(c ** -0.5), **kw)
        self.in_proj_kernel = make_param((NUM_SETS, c, 3 * c), _xavier((NUM_SETS, c, 3 * c)),
                                         **kw)
        self.in_proj_bias = make_param((NUM_SETS, 3 * c), zeros_init, **kw)
        self.out_proj_kernel = make_param((NUM_SETS, c, c), _xavier((NUM_SETS, c, c)), **kw)
        self.out_proj_bias = make_param((NUM_SETS, c), zeros_init, **kw)
        for name, table in (("mod_sets", MOD_SETS), ("mm_to_set", MM_TO_SET),
                            ("set_to_mm", SET_TO_MM)):
            self.register_buffer(name, torch.as_tensor(table, device=device), persistent=False)

    def forward(self, patches: torch.Tensor, globals_: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        m, b, n, c = patches.shape
        h = c // 64  # nn.MultiheadAttention heads of 64 (AttnMOE.py:142 of the reference)
        d = c // h
        seg = n + 1
        dt = self.dtype
        scale = d ** -0.5
        ms = self.mod_sets
        segs = torch.cat([globals_[:, :, None], patches], dim=2).to(dt)  # (3, B, seg, C)

        wq, wk, wv = cached_cast(self, "in_proj_kernel", dt).split(c, dim=-1)
        bq, bk, bv = cached_cast(self, "in_proj_bias", dt).split(c, dim=-1)
        q = torch.einsum("sc,scd->sd", cached_cast(self, "set_tokens", dt), wq) + bq
        q = q.reshape(NUM_SETS, h, d)

        # v modality-major: (3, B, seg, 4, h, d).
        vv = torch.einsum("mblc,mjcd->mbljd", segs, wv[ms]) + bv[ms][:, None, None]
        vv = vv.reshape(m, b, seg, 4, h, d)

        # k folded into u = W_k^T q: logits (3, B, seg, 4, h) in f32.
        qg = q[ms]  # (3, 4, h, d)
        u = torch.einsum("mjchd,mjhd->mjhc", wk[ms].reshape(m, 4, c, h, d), qg)
        lbias = torch.einsum("mjhd,mjhd->mjh", bk[ms].reshape(m, 4, h, d), qg)
        logits = (torch.einsum("mblc,mjhc->mbljh", segs.float(), u.float())
                  + lbias.float()[:, None, None]) * scale
        lg = logits.permute(0, 3, 1, 4, 2).reshape(12, b, h, seg)[self.mm_to_set]

        # One softmax per set over its members' logits jointly.
        probs = []
        for p0, p1, card in CARD_GROUPS:
            x = lg[p0:p1].reshape((p1 - p0) // card, card, b, h, seg)
            e = torch.exp(x - x.amax(dim=(1, 4), keepdim=True))
            p = e / e.sum(dim=(1, 4), keepdim=True)
            if train:
                p = dropout(p, self.dropout, generator, batch_axis=2)
            probs.append(p.reshape(p1 - p0, b, h, seg))
        probs = torch.cat(probs)[self.set_to_mm].reshape(m, 4, b, h, seg)
        probs = probs.permute(0, 2, 4, 1, 3).to(dt)  # (3, B, seg, 4, h)

        # PV in v's layout, then each set sums its members' partial outputs.
        out = (vv * probs[..., None]).sum(2)  # (3, B, 4, h, d)
        pairs = out.transpose(1, 2).reshape(12, b, c)[self.mm_to_set]
        out = torch.cat([pairs[p0:p1].reshape((p1 - p0) // card, card, b, c).sum(1)
                         for p0, p1, card in CARD_GROUPS])  # (7, B, C)
        out = torch.einsum("sbc,scd->sbd", out, cached_cast(self, "out_proj_kernel", dt))
        return out + cached_cast(self, "out_proj_bias", dt)[:, None, :]


class ATMoE(nn.Module):
    """The reference's `MoM`: (7, B, C) set features -> (B, 7C)."""

    def __init__(self, feat_dim: int, *, head: int, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        c, s = feat_dim, NUM_SETS  # an expert per set
        if c % head:
            raise ValueError(f"ATMoE: feat_dim {c} is not divisible by MODEL.HEAD={head}")
        d = c // head
        self.head = head
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.linear_re_fc = Linear(s * c, c, **kw)
        self.linear_re_bn = TorchBatchNorm(c, device=device, use_bias=True)
        self.gate_q = Linear(c, c, bias=False, **kw)
        self.gate_k = Linear(c, c, bias=False, **kw)
        # flax variance_scaling(1/3, 'fan_in', 'uniform') on (head, 7, d, d):
        # fan_in = head * 7 * d.
        self.expert_kernel = make_param((head, s, d, d),
                                        uniform_init(1.0 / math.sqrt(head * s * d)),
                                        generator=generator, device=device)
        self.expert_bias = make_param((head, s, d), zeros_init, generator=generator,
                                      device=device)
        self.expert_bn = TorchBatchNorm(s * c, device=device, use_bias=True)

    def forward(self, feats: torch.Tensor, train: bool = False) -> torch.Tensor:
        s, b, c = feats.shape
        hd = self.head
        d = c // hd
        dt = self.dtype
        # The attention gate: one query from all 7 features, a key per feature.
        x = self.linear_re_bn(quick_gelu(self.linear_re_fc(torch.cat(list(feats), dim=-1))),
                              train)
        qh = self.gate_q(x).reshape(b, hd, 1, d)
        kh = self.gate_k(feats.transpose(0, 1)).reshape(b, s, hd, d).transpose(1, 2)
        attn = torch.einsum("bhqd,bhsd->bhqs", qh.float(), kh.float())
        gates = torch.softmax(attn * d ** -0.5, dim=-1)  # (B, hd, 1, 7)

        # Expert i of head h takes chunk h of feature i.
        xs = feats.transpose(0, 1).reshape(b, s, hd, d).to(dt)
        y = torch.einsum("bshd,hsde->bshe", xs, cached_cast(self, "expert_kernel", dt))
        y = quick_gelu(y + cached_cast(self, "expert_bias", dt).transpose(0, 1)[None])
        y = self.expert_bn(y.reshape(b, s * c), train).reshape(b, s, hd, d)
        y = y * gates[:, :, 0, :].transpose(1, 2)[..., None].to(y.dtype)
        return y.reshape(b, s * c)


class GeneralFusion(nn.Module):
    """HDM, then ATMoE (MODEL.ATM) or the 7 set features concatenated:
    (B, 7C).  HDM runs whatever MODEL.HDM says, as in the JAX package."""

    def __init__(self, feat_dim: int, *, use_atm: bool, head: int, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator, dropout: float = 0.1):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.hdm = HDM(feat_dim, dropout=dropout, **kw)
        self.moe = ATMoE(feat_dim, head=head, **kw) if use_atm else None

    def forward(self, patches: torch.Tensor, globals_: torch.Tensor, train: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        feats = self.hdm(patches, globals_, train, generator)
        if self.moe is not None:
            return self.moe(feats, train)
        s, b, c = feats.shape
        return feats.transpose(0, 1).reshape(b, s * c)
