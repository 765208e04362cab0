"""Multi-head attention in torch's packed in_proj layout
(demo2_tpu/ops/attention.py, the plain path: `_xla_attention` and
`MultiHeadAttention` with implementation='xla').

Serves the CLIP blocks when the fused kernels are off and DGAF's attention
pool, whose query has length 1 (cross-attention).  Scores and softmax run in
f32 whatever the compute dtype; the probabilities are cast to the value
dtype before the PV product, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from .linear import Linear, cached_cast, make_param, xavier_uniform_init, zeros_init


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float) -> torch.Tensor:
    """Scaled dot-product attention on (B, S, H, D) tensors."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        c = embed_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = make_param((3 * c, c), xavier_uniform_init(c, 3 * c),
                                         generator=generator, device=device)
        self.in_proj_bias = make_param((3 * c,), zeros_init, generator=generator, device=device)
        self.out_proj = Linear(c, c, dtype=dtype, device=device, generator=generator)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Sq, C), key/value (B, Sk, C); self-attention if omitted."""
        key = query if key is None else key
        value = key if value is None else value
        dt = self.dtype
        b, sq, c = query.shape
        h = self.num_heads
        wq, wk, wv = cached_cast(self, "in_proj_weight", dt).chunk(3, dim=0)
        bq, bk, bv = cached_cast(self, "in_proj_bias", dt).chunk(3)
        q = F.linear(query.to(dt), wq, bq).view(b, sq, h, c // h)
        k = F.linear(key.to(dt), wk, bk).view(b, key.shape[1], h, c // h)
        v = F.linear(value.to(dt), wv, bv).view(b, value.shape[1], h, c // h)
        out = attention_core(q, k, v, scale=(c // h) ** -0.5)
        return self.out_proj(out.reshape(b, sq, c))
