"""ImageNet ViT backbone, the 'vit_base_patch16_224' family
(demo2_tpu/models/vit.py).

Conv patch embed with bias (overlap-capable: any stride) -> CLS token +
positional embedding -> SIE camera / view embedding added to ALL tokens,
scaled by `sie_xishu` -> dropout -> pre-LN blocks (LayerNorm eps 1e-6,
timm attention with a packed qkv Linear, exact-GELU MLP, stochastic depth
decaying linearly over the blocks) -> final LayerNorm; returns all tokens
(B, N+1, C).  Images are NHWC at the module boundary, as in the JAX package.

With implementation="pallas" (cfg.TPU.USE_FLASH_ATTENTION) each block's
attention is ops/packed_attention.py::packed_self_attention on the packed
qkv, i.e. the CUDA kernels 5 (forward) and 6 (backward) on a CUDA tensor,
unless attention dropout is active; otherwise ops/attention.py's
attention_core.  Every random draw (dropout, drop path) comes from the
`generator` the caller passes, as flax's 'dropout' rng in the JAX package;
the two give different numbers, so the tests feed both the same masks.
With `remat` (cfg.TPU.REMAT_BACKBONE) each block of a training forward runs
under torch.utils.checkpoint (`checkpointed_block`), whose recompute draws
the masks the forward drew.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.activations import gelu
from ..ops.attention import attention_core
from ..ops.linear import Linear, cached_cast, make_param, normal_init
from ..ops.norm import LayerNorm
from ..ops.packed_attention import packed_self_attention
from ..parallel.collectives import batch_rand
from .clip_vit import PatchConv
from .sdtps import dropout

LN_EPS = 1e-6


class ViTAttention(nn.Module):
    """timm attention: packed qkv Linear (bias optional) + proj."""

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, implementation: str = "xla", dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale if qk_scale is not None else (dim // num_heads) ** -0.5
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.implementation = implementation
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, **kw)
        self.proj = Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x)
        if self.implementation == "pallas" and (self.attn_drop == 0.0 or not train):
            out = packed_self_attention(qkv, h, self.scale)
        else:
            q, k, v = (t.reshape(b, n, h, c // h) for t in qkv.split(c, dim=-1))
            out = attention_core(q, k, v, scale=self.scale, dropout_rate=self.attn_drop,
                                 deterministic=not train, generator=generator,
                                 implementation=self.implementation).reshape(b, n, c)
        out = self.proj(out)
        if train:
            out = dropout(out, self.proj_drop, generator)
        return out


class ViTMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, *, drop: float = 0.0, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        self.drop = drop
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.fc1 = Linear(dim, hidden, **kw)
        self.fc2 = Linear(hidden, dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = gelu(self.fc1(x))
        if train:
            x = dropout(x, self.drop, generator)
        x = self.fc2(x)
        if train:
            x = dropout(x, self.drop, generator)
        return x


def drop_path(x: torch.Tensor, rate: float, *, train: bool,
              generator: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample stochastic depth: keep each sample with probability
    keep = 1 - rate and divide the kept ones by keep.  `mask` (B,) bool, if
    given, is the draw (a test feeds JAX's); else it is drawn from
    `generator`."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = batch_rand((x.shape[0],), generator=generator, device=x.device) < keep
    mask = mask.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 implementation: str = "xla", dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm1 = LayerNorm(dim, device=device, eps=LN_EPS)
        self.attn = ViTAttention(dim, num_heads, qkv_bias=qkv_bias, qk_scale=qk_scale,
                                 attn_drop=attn_drop, proj_drop=drop,
                                 implementation=implementation, **kw)
        self.norm2 = LayerNorm(dim, device=device, eps=LN_EPS)
        self.mlp = ViTMlp(dim, int(dim * mlp_ratio), drop=drop, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.attn(self.norm1(x), train, generator)
        x = x + drop_path(y, self.drop_path_rate, train=train, generator=generator)
        y = self.mlp(self.norm2(x), train, generator)
        return x + drop_path(y, self.drop_path_rate, train=train, generator=generator)


def checkpointed_block(block: nn.Module, x: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """block(x, train=True, generator) under torch.utils.checkpoint.  The
    checkpoint keeps the default generators' states for the recompute, not a
    caller's: so the recompute starts `generator` from its state at the
    forward, and so draws the same dropout and drop-path masks, then gives
    it back the state it had."""
    if generator is None:  # the default generators: checkpoint keeps those
        return checkpoint(block, x, True, None, use_reentrant=False)
    start = generator.get_state()
    ran = []

    def run(x):
        if not ran:  # the forward
            ran.append(True)
            return block(x, True, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return block(x, True, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False)


class ImageNetViT(nn.Module):
    """`Trans` of the reference: (B, H, W, 3) -> (B, N+1, embed_dim)."""

    def __init__(self, *, img_size: Tuple[int, int] = (256, 128), patch_size: int = 16,
                 stride_size: Tuple[int, int] = (16, 16), embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, camera: int = 0, view: int = 0,
                 sie_xishu: float = 1.5, attn_implementation: str = "xla",
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.img_size, self.patch_size, self.stride_size = img_size, patch_size, stride_size
        self.embed_dim = embed_dim
        self.camera, self.view, self.sie_xishu = camera, view, sie_xishu
        self.drop_rate = drop_rate
        self.dtype = dtype
        num_y, num_x = self.grid
        kw = dict(device=device, generator=generator)
        self.patch_embed_proj = PatchConv(embed_dim, patch_size, tuple(stride_size), dtype=dtype,
                                          bias=True, **kw)
        self.cls_token = make_param((1, 1, embed_dim), normal_init(0.02), **kw)
        self.pos_embed = make_param((1, num_y * num_x + 1, embed_dim), normal_init(0.02), **kw)
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

    @property
    def grid(self) -> Tuple[int, int]:
        (h, w), (sh, sw) = self.img_size, self.stride_size
        return (h - self.patch_size) // sh + 1, (w - self.patch_size) // sw + 1

    def forward(self, x: torch.Tensor, camera_id: Optional[torch.Tensor] = None,
                view_id: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        b = x.shape[0]
        x = self.patch_embed_proj(x)
        cls = cached_cast(self, "cls_token", dt).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + cached_cast(self, "pos_embed", dt)
        if self.sie_embed is not None:  # SIE on ALL tokens (vit.py:232-257)
            if self.camera > 1 and self.view > 1:
                idx = camera_id.long() * self.view + view_id.long()
            else:
                idx = (camera_id if self.camera > 1 else view_id).long()
            x = x + self.sie_xishu * cached_cast(self, "sie_embed", dt)[idx]
        if train:
            x = dropout(x, self.drop_rate, generator)
        for blk in self.blocks:
            if train and self.remat:
                x = checkpointed_block(blk, x, generator)
            else:
                x = blk(x, train, generator)
        return self.norm(x)
