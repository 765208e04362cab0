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
same conditions goes to the packed kernels (ops/packed_attention.py).

LoRA on the in-projection (MODEL.FROZEN with TPU.LORA_RANK > 0) keeps JAX's
parameters as they are: `lora_a` (C, r) and `lora_b` (r, 3C) for the whole
matrix, or `lora_a` (n_on, C, r) and `lora_b` (n_on, r, C) for the enabled
q / k / v slices of TPU.LORA_ENABLE (the MergedLinear form).  Their delta is
in JAX's (C, 3C) kernel layout, so it is transposed where it is added to
torch's (3C, C) `in_proj_weight`.  `conv_lora_delta` is the patch embed's
ConvLoRA delta in the same reference layout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from .flash_attention import flash_attention
from .linear import (Linear, cached_cast, cached_merge, make_param, normal_init,
                     xavier_uniform_init, zeros_init)
from ..parallel.collectives import batch_rand
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
        keep = batch_rand(shape, generator=generator, device=q.device) < 1.0 - dropout_rate
    return plain_attention(q, k, v, scale=scale, mask_bias=mask_bias,
                           dropout_rate=dropout_rate, keep=keep)


def conv_lora_delta(lora_a: torch.Tensor, lora_b: torch.Tensor, out_ch: int, in_ch: int,
                    k: int) -> torch.Tensor:
    """attention.py::conv_lora_delta in torch's OIHW conv layout: lora_a
    (r*k, in*k) and lora_b (out*k, r*k) in the reference's layout, the delta
    B @ A read row-major as (out, in, k, k).  The reference's alpha / r
    scaling is folded into B where a checkpoint is converted."""
    return (lora_b @ lora_a).reshape(out_ch, in_ch, k, k)


def merged_lora_delta(lora_a: torch.Tensor, lora_b: torch.Tensor, enable) -> torch.Tensor:
    """attention.py::merged_lora_delta: lora_a (n_on, c, r), lora_b (n_on,
    r, c); each enabled slice s of the packed (c, n*c) kernel gets a_s @ b_s,
    a disabled one zeros.  Returns the (c, n*c) delta in JAX's layout."""
    deltas = torch.einsum("ncr,nrd->ncd", lora_a, lora_b)
    zero = deltas.new_zeros(deltas.shape[1:])
    on = iter(deltas)
    return torch.cat([next(on) if e else zero for e in enable], dim=1)


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator,
                 dropout_rate: float = 0.0, implementation: str = "xla",
                 lora_rank: int = 0, lora_enable=(True, True, True)):
        super().__init__()
        c = embed_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.implementation = implementation
        self.lora_rank = lora_rank if any(lora_enable) else 0
        self.lora_enable = tuple(bool(e) for e in lora_enable)
        self.in_proj_weight = make_param((3 * c, c), xavier_uniform_init(c, 3 * c),
                                         generator=generator, device=device)
        r = self.lora_rank
        if r:
            kw = dict(generator=generator, device=device)
            if all(self.lora_enable):
                self.lora_a = make_param((c, r), normal_init(1.0 / r), **kw)
                self.lora_b = make_param((r, 3 * c), zeros_init, **kw)
            else:
                n_on = sum(self.lora_enable)
                self.lora_a = make_param((n_on, c, r), normal_init(1.0 / r), **kw)
                self.lora_b = make_param((n_on, r, c), zeros_init, **kw)
        self.in_proj_bias = make_param((3 * c,), zeros_init, generator=generator, device=device)
        self.out_proj = Linear(c, c, dtype=dtype, device=device, generator=generator)

    def lora_delta(self) -> torch.Tensor:
        """The LoRA delta of the packed kernel, (C, 3C) in JAX's layout."""
        if all(self.lora_enable):
            return self.lora_a @ self.lora_b
        return merged_lora_delta(self.lora_a, self.lora_b, self.lora_enable)

    def qkv_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The (3C, C) in-projection in `dtype`, the LoRA delta merged in:
        differentiable where a gradient is to flow to W, A or B, else cast
        (and merged) once until one of them changes."""
        if not self.lora_rank:
            return cached_cast(self, "in_proj_weight", dtype)
        return cached_merge(self, "in_proj_weight", (self.in_proj_weight, self.lora_a, self.lora_b),
                            dtype, lambda: self.in_proj_weight + self.lora_delta().t())

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
        weight = self.qkv_weight(dt)
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
