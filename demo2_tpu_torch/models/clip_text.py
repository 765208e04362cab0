"""CLIP text encoder (demo2_tpu/models/clip_text.py; reference:
modeling/clip/model.py:489-606).

`CLIPTextTransformer` is `CLIP.encode_text`: the token embedding (with an
optional LoRA delta), the (77, W) positional embedding, the causal
transformer (an additive -1e30 bias over the strict upper triangle), the
final LayerNorm, then the EOT token's feature projected.  `PromptLearner` is
CLIP-ReID's prompt learner, whose prompts enter the encoder past the token
embedding.  No DeMo configuration runs this tower; it is part of the
reference surface.  The JAX package runs it outside Pallas, and so does the
port: its masked attention goes through ops/attention.py's plain
`attention_core`, on plain ops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.activations import quick_gelu
from ..ops.attention import MultiHeadAttention
from ..ops.linear import Linear, cached_cast, make_param, normal_init, zeros_init
from ..ops.norm import LayerNorm


class _TextBlock(nn.Module):
    """Pre-LN block with an additive attention mask (clip/model.py:168-230)."""

    def __init__(self, width: int, heads: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.ln_1 = LayerNorm(width, device=device)
        self.attn = MultiHeadAttention(width, heads, **kw)
        self.ln_2 = LayerNorm(width, device=device)
        self.mlp_c_fc = Linear(width, 4 * width, **kw)
        self.mlp_c_proj = Linear(4 * width, width, **kw)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask_bias=mask_bias)
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))


def lora_embedding_delta(lora_a: torch.Tensor, lora_b: torch.Tensor, ids: torch.Tensor,
                         alpha: float) -> torch.Tensor:
    """The low-rank delta of an embedding lookup (reference clip/LoRA.py:33-90):
    lora_a (r, vocab), lora_b (width, r); A.T[ids] @ B.T, times alpha.
    Returns (..., width)."""
    return alpha * (lora_a.t()[ids] @ lora_b.t())


def adapted_token_embedding(tok: torch.Tensor, lora_a: torch.Tensor, lora_b: torch.Tensor,
                            alpha: float) -> torch.Tensor:
    """The whole table with the embedding adapter merged in, tok + alpha *
    A.T @ B.T: what PromptLearner reads where the tower has token LoRA (its
    prompts enter past the lookup, so no per-id delta reaches them)."""
    return tok + alpha * (lora_a.t() @ lora_b.t())


class CLIPTextTransformer(nn.Module):
    """`encode_text`: (B, 77) token ids, or prompt embeddings with their EOT
    positions, -> (B, embed_dim) f32.  `lora_rank` > 0 adds the token
    embedding's LoRA adapter (A zeros, B normal(1), as the reference's
    Embedding initialises them)."""

    def __init__(self, *, dtype: torch.dtype, device: torch.device, generator: torch.Generator,
                 vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, embed_dim: int = 512, lora_rank: int = 0,
                 lora_alpha: float = 1.0):
        super().__init__()
        self.dtype = dtype
        self.context_length = context_length
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        kw = dict(generator=generator, device=device)
        self.token_embedding = make_param((vocab_size, width), normal_init(0.02), **kw)
        self.positional_embedding = make_param((context_length, width), normal_init(0.01), **kw)
        if lora_rank > 0:
            self.token_lora_a = make_param((lora_rank, vocab_size), zeros_init, **kw)
            self.token_lora_b = make_param((width, lora_rank), normal_init(1.0), **kw)
        self.resblocks = nn.ModuleList(
            _TextBlock(width, heads, dtype=dtype, device=device, generator=generator)
            for _ in range(layers))
        self.ln_final = LayerNorm(width, device=device)
        self.text_projection = make_param((width, embed_dim), normal_init(width ** -0.5), **kw)

    def forward(self, text: Optional[torch.Tensor] = None, *,
                prompt_embeds: Optional[torch.Tensor] = None,
                eot_idx=None) -> torch.Tensor:
        """Token ids OR pre-embedded prompts (B, 77, width) -> (B, embed_dim).
        The embedded path (CLIP-ReID's TextEncoder) skips the token embedding
        and pools at `eot_idx` (an int or (B,)); the id path pools at each
        row's largest id, the EOT token (49407)."""
        if (text is None) == (prompt_embeds is None):
            raise ValueError("pass exactly one of text / prompt_embeds")
        if prompt_embeds is not None and eot_idx is None:
            raise ValueError("prompt_embeds requires eot_idx")
        dt = self.dtype
        pos = cached_cast(self, "positional_embedding", dt)
        if prompt_embeds is not None:
            x = prompt_embeds.to(dt) + pos
        else:
            text = text.long()
            x = self.token_embedding[text].to(dt) + pos
            if self.lora_rank > 0:
                x = x + lora_embedding_delta(self.token_lora_a, self.token_lora_b, text,
                                             self.lora_alpha).to(dt)
        s = self.context_length
        causal = torch.triu(torch.full((s, s), -1e30, device=x.device), diagonal=1)[None, None]
        for blk in self.resblocks:
            x = blk(x, causal)
        x = self.ln_final(x)
        b = x.shape[0]
        if eot_idx is not None:
            eot = torch.as_tensor(eot_idx, device=x.device).long().expand(b)
        else:
            eot = text.argmax(-1)
        pooled = x[torch.arange(b, device=x.device), eot]
        return pooled.float() @ self.text_projection


class PromptLearner(nn.Module):
    """CLIP-ReID's prompt learner (reference make_model_clipreid.py:190-237):
    "A photo of a X X X X person." (or "... vehicle.") tokenized once, its
    SOT + context prefix and its suffix looked up in the live token table,
    the four X slots replaced by per-class learned vectors (normal 0.02).
    forward(labels, token_embedding) -> (B, 77, ctx_dim) prompts for
    CLIPTextTransformer(prompt_embeds=..., eot_idx=self.eot_pos).  With token
    LoRA on the tower, pass adapted_token_embedding(...) as the table."""

    def __init__(self, num_class: int, *, device: torch.device, generator: torch.Generator,
                 ctx_dim: int = 512, n_ctx: int = 4, n_cls_ctx: int = 4, vehicle: bool = False,
                 context_length: int = 77):
        super().__init__()
        from ..utils.bpe import tokenize

        self.n_ctx, self.n_cls_ctx = n_ctx, n_cls_ctx
        text = "A photo of a X X X X vehicle." if vehicle else "A photo of a X X X X person."
        self.template_ids = tokenize(text, context_length=context_length)[0]
        self.eot_pos = int(np.argmax(self.template_ids))
        self.cls_ctx = make_param((num_class, n_cls_ctx, ctx_dim), normal_init(0.02),
                                  generator=generator, device=device)

    def forward(self, labels: torch.Tensor, token_embedding: torch.Tensor) -> torch.Tensor:
        ids = torch.as_tensor(self.template_ids, device=token_embedding.device).long()
        emb = token_embedding[ids].float()  # (77, D)
        prefix = emb[: self.n_ctx + 1]  # SOT + "a photo of a"
        suffix = emb[self.n_ctx + 1 + self.n_cls_ctx:]  # ".<EOT>" + padding
        b = labels.shape[0]
        return torch.cat([prefix.expand(b, *prefix.shape), self.cls_ctx[labels.long()],
                          suffix.expand(b, *suffix.shape)], dim=1)
