"""T2T-ViT backbone, 't2t_vit_t_14' / 't2t_vit_t_24' (demo2_tpu/models/t2t.py).

The tokens-to-token pyramid: unfold(7, stride 4, pad 2) -> a single-head
token transformer -> unfold(3, 2, 1) -> a second one -> unfold(3, 2, 1) ->
a linear projection to the embedding width, 16-stride in all (16 x 8 tokens
at 256 x 128).  Then a CLS token, the fixed sinusoid position table (not a
parameter), SIE added to ALL tokens, dropout, the ImageNet ViT's blocks
(models/vit.py::ViTBlock; with cfg.TPU.USE_FLASH_ATTENTION their attention is
the packed self-attention, kernels 5 and 6 on the card) with stochastic depth
decaying linearly, under torch.utils.checkpoint with `remat`, and the final
LayerNorm.  Images are NHWC at the module boundary, as in the JAX package.

The token transformers keep the reference's two quirks: the softmax scale is
the INPUT width's (147 and 576), and the residual skips from V, since the
input and output widths differ.  Their single-head attention over 2,048 and
512 tokens is torch.matmul and a softmax, as JAX computes it outside Pallas:
the scores in f32 from the compute-dtype q and k, the probabilities cast back
to the compute dtype for the product with v.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.linear import Linear, cached_cast, make_param, normal_init
from ..ops.norm import LayerNorm
from .sdtps import dropout
from .vit import LN_EPS, ViTBlock, ViTMlp, checkpointed_block


def sinusoid_encoding(n_position: int, d_hid: int) -> np.ndarray:
    """The fixed sinusoid position table, (1, n_position, d_hid) f32."""
    pos = np.arange(n_position)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (hid // 2) / d_hid)
    table = np.where(hid % 2 == 0, np.sin(angle), np.cos(angle))
    return table[None].astype(np.float32)


def unfold(x_nchw: torch.Tensor, k: int, s: int, p: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, C, H, W) -> ((B, L, C*k*k) token-major, the (H', W') grid): torch's
    unfold, whose feature order (C-major, kernel position minor) JAX's
    conv_general_dilated_patches repeats."""
    h, w = x_nchw.shape[2:]
    grid = ((h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1)
    return F.unfold(x_nchw, k, padding=p, stride=s).transpose(1, 2), grid


class TokenTransformer(nn.Module):
    """A tokens-to-token stage: single-head attention from `dim` to `in_dim`
    with the input width's scale and the V-skip residual, then an MLP."""

    def __init__(self, dim: int, in_dim: int, mlp_ratio: float = 1.0, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.in_dim = in_dim
        self.scale = float(dim) ** -0.5
        self.norm1 = LayerNorm(dim, device=device, eps=1e-5)
        self.qkv = Linear(dim, 3 * in_dim, bias=False, **kw)
        self.proj = Linear(in_dim, in_dim, **kw)
        self.norm2 = LayerNorm(in_dim, device=device, eps=1e-5)
        self.mlp = ViTMlp(in_dim, int(in_dim * mlp_ratio), **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q, k, v = self.qkv(self.norm1(x)).split(self.in_dim, dim=-1)
        logits = (q * self.scale).float() @ k.float().transpose(-1, -2)
        attn = torch.softmax(logits, dim=-1).to(q.dtype)
        x = v + self.proj(attn @ v)
        return x + self.mlp(self.norm2(x), train, generator)


class T2TModule(nn.Module):
    """The 'transformer' tokens-to-token pyramid: (B, H, W, 3) ->
    (B, H/16 * W/16, embed_dim)."""

    def __init__(self, embed_dim: int = 384, token_dim: int = 64, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.dtype = dtype
        self.token_dim = token_dim
        self.attention1 = TokenTransformer(3 * 7 * 7, token_dim, **kw)
        self.attention2 = TokenTransformer(token_dim * 3 * 3, token_dim, **kw)
        self.project = Linear(token_dim * 3 * 3, embed_dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = x.shape[0]
        t, hw = unfold(x.permute(0, 3, 1, 2).to(self.dtype), 7, 4, 2)
        t = self.attention1(t, train, generator)
        t, hw = unfold(t.transpose(1, 2).reshape(b, self.token_dim, *hw), 3, 2, 1)
        t = self.attention2(t, train, generator)
        t, _ = unfold(t.transpose(1, 2).reshape(b, self.token_dim, *hw), 3, 2, 1)
        return self.project(t)


# (embed_dim, depth, num_heads) per name, JAX's T2T_CONFIGS
T2T_CONFIGS = {
    "t2t_vit_t_14": (384, 14, 6),
    "t2t_vit_t_24": (512, 24, 8),
}


class T2TViT(nn.Module):
    """The trunk: (B, H, W, 3) -> (B, N+1, embed_dim) after the final
    LayerNorm, as ImageNetViT returns them."""

    def __init__(self, *, img_size: Tuple[int, int] = (256, 128), embed_dim: int = 384,
                 depth: int = 14, num_heads: int = 6, mlp_ratio: float = 3.0,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None, token_dim: int = 64,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, camera: int = 0, view: int = 0,
                 sie_xishu: float = 1.5, attn_implementation: str = "xla",
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator,
                 remat: bool = False):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.camera, self.view, self.sie_xishu = camera, view, sie_xishu
        self.drop_rate = drop_rate
        self.remat = remat
        self.tokens_to_token = T2TModule(embed_dim, token_dim, dtype=dtype, **kw)
        self.cls_token = make_param((1, 1, embed_dim), normal_init(0.02), **kw)
        n = (img_size[0] // 16) * (img_size[1] // 16)
        self.register_buffer("pos", torch.from_numpy(sinusoid_encoding(n + 1, embed_dim)).to(
            device), persistent=False)
        sie_rows = (camera * view if camera > 1 and view > 1 else
                    camera if camera > 1 else view if view > 1 else 0)
        self.sie_embed = (make_param((sie_rows, 1, embed_dim), normal_init(0.02), **kw)
                          if sie_rows else None)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                     qk_scale=qk_scale, drop=drop_rate, attn_drop=attn_drop_rate,
                     drop_path_rate=drop_path_rate * i / max(depth - 1, 1),
                     implementation=attn_implementation, dtype=dtype, **kw)
            for i in range(depth)
        )
        self.norm = LayerNorm(embed_dim, device=device, eps=LN_EPS)

    def forward(self, x: torch.Tensor, camera_id: Optional[torch.Tensor] = None,
                view_id: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        tokens = self.tokens_to_token(x, train, generator)
        b, n = tokens.shape[:2]
        cls = cached_cast(self, "cls_token", dt).expand(b, 1, self.embed_dim)
        pos = self.pos if self.pos.shape[1] == n + 1 else torch.from_numpy(
            sinusoid_encoding(n + 1, self.embed_dim)).to(tokens.device)
        tokens = torch.cat([cls, tokens], dim=1) + pos.to(dt)
        if self.sie_embed is not None:  # SIE on ALL tokens
            if self.camera > 1 and self.view > 1:
                idx = camera_id.long() * self.view + view_id.long()
            else:
                idx = (camera_id if self.camera > 1 else view_id).long()
            tokens = tokens + self.sie_xishu * cached_cast(self, "sie_embed", dt)[idx]
        if train:
            tokens = dropout(tokens, self.drop_rate, generator)
        for blk in self.blocks:
            if train and self.remat:
                tokens = checkpointed_block(blk, tokens, generator)
            else:
                tokens = blk(tokens, train, generator)
        return self.norm(tokens)
