"""Multi-head attention in torch's packed in_proj layout
(demo2_tpu/ops/attention.py: `attention_core`, `_xla_attention` and
`MultiHeadAttention`).

Serves the CLIP blocks when the fused kernels are off, DGAF's attention pool
(a query of length 1: cross-attention) and every attention that names an
`implementation`.  The plain path runs the scores and softmax in f32 whatever
the compute dtype, adds an additive mask bias, applies dropout to the
probabilities (drawn from an explicit torch.Generator) and casts them to the
value dtype before the PV product, as the JAX package does.  With
implementation="pallas" the JAX package's kernel routes are taken under its
exact conditions: attention_core goes to the head-major kernels
(ops/flash_attention.py) when there is no mask, no active dropout and the
query and key lengths agree; MultiHeadAttention's self-attention under the
same conditions goes to the packed kernels (ops/packed_attention.py).  LoRA
on the in-projection is not ported (ROADMAP.md, port queue: the rest of the
modules).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from .flash_attention import flash_attention
from .linear import Linear, cached_cast, make_param, xavier_uniform_init, zeros_init
from .packed_attention import packed_self_attention


def plain_attention(q, k, v, *, scale: float, mask_bias=None, dropout_rate: float = 0.0,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """attention.py::_xla_attention on (B, S, H, D) tensors.  `keep` is the
    dropout's (B, H, Sq, Sk) Bernoulli(1 - rate) draw, or None for none."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask_bias is not None:
        logits = logits + mask_bias
    probs = torch.softmax(logits, dim=-1)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                   mask_bias: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                   deterministic: bool = True, generator: Optional[torch.Generator] = None,
                   implementation: str = "xla") -> torch.Tensor:
    """Scaled dot-product attention on (B, S, H, D) tensors."""
    active_dropout = dropout_rate > 0.0 and not deterministic
    if (implementation == "pallas" and mask_bias is None and not active_dropout
            and q.shape[1] == k.shape[1]):
        return flash_attention(q, k, v, scale=scale)
    keep = None
    if active_dropout:
        shape = (q.shape[0], q.shape[2], q.shape[1], k.shape[1])
        keep = torch.rand(shape, generator=generator, device=q.device) < 1.0 - dropout_rate
    return plain_attention(q, k, v, scale=scale, mask_bias=mask_bias,
                           dropout_rate=dropout_rate, keep=keep)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator,
                 dropout_rate: float = 0.0, implementation: str = "xla"):
        super().__init__()
        c = embed_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.implementation = implementation
        self.in_proj_weight = make_param((3 * c, c), xavier_uniform_init(c, 3 * c),
                                         generator=generator, device=device)
        self.in_proj_bias = make_param((3 * c,), zeros_init, generator=generator, device=device)
        self.out_proj = Linear(c, c, dtype=dtype, device=device, generator=generator)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None, *,
                mask_bias: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query (B, Sq, C), key/value (B, Sk, C); self-attention if omitted.
        `train` makes the dropout active, drawn from `generator`."""
        key = query if key is None else key
        value = key if value is None else value
        dt = self.dtype
        b, sq, c = query.shape
        h = self.num_heads
        scale = (c // h) ** -0.5
        weight = cached_cast(self, "in_proj_weight", dt)
        bias = cached_cast(self, "in_proj_bias", dt)
        is_self_attn = key is query and value is key
        if (self.implementation == "pallas" and is_self_attn and mask_bias is None
                and (self.dropout_rate == 0.0 or not train)):
            qkv = F.linear(query.to(dt), weight, bias)
            out = packed_self_attention(qkv, h, scale)
        else:
            wq, wk, wv = weight.chunk(3, dim=0)
            bq, bk, bv = bias.chunk(3)
            q = F.linear(query.to(dt), wq, bq).view(b, sq, h, c // h)
            k = F.linear(key.to(dt), wk, bk).view(b, key.shape[1], h, c // h)
            v = F.linear(value.to(dt), wv, bv).view(b, value.shape[1], h, c // h)
            out = attention_core(q, k, v, scale=scale, mask_bias=mask_bias,
                                 dropout_rate=self.dropout_rate, deterministic=not train,
                                 generator=generator, implementation=self.implementation)
        return self.out_proj(out.reshape(b, sq, c))
