"""CLIP ViT visual tower (demo2_tpu/models/clip_vit.py).

Patch conv (no bias) -> CLS (+ the SIE camera embedding, on CLS only) ->
positional embedding -> ln_pre -> residual blocks -> ln_post -> proj; all
tokens are returned, projected.  Images are NHWC at the module boundary, as
in the JAX package.

With `fused=True` (cfg.TPU.USE_FLASH_ATTENTION) each block runs the fused
sub-blocks of ops/fused_block.py, i.e. the CUDA kernels on a CUDA tensor:
the fused attention always, with its custom backward wherever a gradient has
to flow; the fused MLP where `not train or fused_mlp_train`
(cfg.TPU.FUSED_MLP_TRAIN), with its custom backward likewise, else the
unfused ln_2 + MLP, as in the JAX package.  Otherwise the plain LayerNorm /
MHA / MLP modules.  `pallas_ln_bwd` (cfg.TPU.PALLAS_LN_BWD) gives the blocks'
unfused LayerNorms the one-pass backward of ops/norm.py: ln_2 where the MLP is
unfused, ln_1 where the attention is (fused, each lives inside its
sub-block's kernels); not ln_pre / ln_post.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import quick_gelu
from ..ops.attention import MultiHeadAttention
from ..ops.fused_block import fused_attention, fused_mlp, needs_grad
from ..ops.linear import (Linear, cached_cast, make_param, normal_init,
                          truncated_normal_init, zeros_init)
from ..ops.norm import LayerNorm


class PatchConv(nn.Module):
    """The patch-embedding conv, VALID: (B, H, W, 3) -> (B, N, width), the
    tokens row-major over the patch grid.  Weight in torch's OIHW layout.
    CLIP's has no bias; the ImageNet ViT's has one (vit.py:206-214).
    `stride` is an int or an (sh, sw) pair."""

    def __init__(self, width: int, patch_size: int, stride, *, dtype: torch.dtype,
                 device: torch.device, generator: torch.Generator, bias: bool = False):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        fan_in = 3 * patch_size * patch_size
        # flax Conv's default lecun_normal: truncated normal of variance 1/fan_in.
        self.weight = make_param(
            (width, 3, patch_size, patch_size),
            truncated_normal_init(math.sqrt(1.0 / fan_in) / 0.87962566103423978),
            generator=generator, device=device,
        )
        self.bias = (make_param((width,), zeros_init, generator=generator, device=device)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), cached_cast(self, "weight", dt),
                     cached_cast(self, "bias", dt), stride=self.stride)
        return y.flatten(2).transpose(1, 2)


class CLIPMlp(nn.Module):
    def __init__(self, width: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.c_fc = Linear(width, 4 * width, dtype=dtype, device=device, generator=generator)
        self.c_proj = Linear(4 * width, width, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x))."""

    def __init__(self, width: int, heads: int, *, dtype: torch.dtype, fused: bool,
                 device: torch.device, generator: torch.Generator,
                 pallas_ln_bwd: bool = False, fused_mlp_train: bool = False):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.fused = fused
        self.fused_mlp_train = fused_mlp_train
        # Fused, ln_1's parameters go to the attention kernels, never through
        # this module's forward.
        self.ln_1 = LayerNorm(width, device=device, pallas_bwd=pallas_ln_bwd and not fused)
        self.attn = MultiHeadAttention(width, heads, dtype=dtype, device=device,
                                       generator=generator)
        self.ln_2 = LayerNorm(width, device=device, pallas_bwd=pallas_ln_bwd)
        self.mlp = CLIPMlp(width, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not self.fused:
            x = x + self.attn(self.ln_1(x))
            return x + self.mlp(self.ln_2(x))
        dt = self.dtype
        attn, mlp = self.attn, self.mlp
        params = (self.ln_1.weight, self.ln_1.bias, attn.in_proj_weight, attn.in_proj_bias,
                  attn.out_proj.weight, attn.out_proj.bias)
        if not needs_grad(x, *params):  # eval: the weights' cached casts
            params = (params[0], params[1], cached_cast(attn, "in_proj_weight", dt), params[3],
                      cached_cast(attn.out_proj, "weight", dt), params[5])
        x = fused_attention(x, *params, num_heads=self.heads,
                            scale=(x.shape[-1] // self.heads) ** -0.5)
        # The MLP is fused where JAX fuses it (clip_vit.py:250): outside
        # training, and in training with TPU.FUSED_MLP_TRAIN.  JAX's fused MLP
        # is differentiable wherever it runs, so an input gradient taken
        # outside training (a saliency map) goes through FusedMlpBlockFn.
        if train and not self.fused_mlp_train:
            return x + self.mlp(self.ln_2(x))
        params = (self.ln_2.weight, self.ln_2.bias, mlp.c_fc.weight, mlp.c_fc.bias,
                  mlp.c_proj.weight, mlp.c_proj.bias)
        if not needs_grad(x, *params):  # eval: the weights' cached casts
            params = (params[0], params[1], cached_cast(mlp.c_fc, "weight", dt), params[3],
                      cached_cast(mlp.c_proj, "weight", dt), params[5])
        return fused_mlp(x, *params)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, h_resolution: int, w_resolution: int, *, stride_size: int,
                 width: int, layers: int, heads: int, dtype: torch.dtype, fused: bool,
                 device: torch.device, generator: torch.Generator,
                 patch_size: int = 16, output_dim: int = 512, pallas_ln_bwd: bool = False,
                 fused_mlp_train: bool = False):
        super().__init__()
        self.width = width
        self.dtype = dtype
        scale = width ** -0.5
        self.conv1 = PatchConv(width, patch_size, stride_size, dtype=dtype, device=device,
                               generator=generator)
        self.class_embedding = make_param((width,), normal_init(scale), generator=generator,
                                          device=device)
        self.positional_embedding = make_param(
            (h_resolution * w_resolution + 1, width), normal_init(scale),
            generator=generator, device=device,
        )
        self.ln_pre = LayerNorm(width, device=device)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype=dtype, fused=fused, device=device,
                                   generator=generator, pallas_ln_bwd=pallas_ln_bwd,
                                   fused_mlp_train=fused_mlp_train)
            for _ in range(layers)
        )
        self.ln_post = LayerNorm(width, device=device)
        self.proj = make_param((width, output_dim), normal_init(scale), generator=generator,
                               device=device)

    def forward(self, x: torch.Tensor, cv_emb: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """x (B, H, W, 3) images, cv_emb (B, width) or None -> (B, N+1, output_dim)."""
        dt = self.dtype
        b = x.shape[0]
        x = self.conv1(x)
        cls = cached_cast(self, "class_embedding", dt).expand(b, 1, self.width)
        if cv_emb is not None:
            cls = cls + cv_emb.to(dt)[:, None, :]
        x = torch.cat([cls, x], dim=1) + cached_cast(self, "positional_embedding", dt)[None]
        x = self.ln_pre(x)
        for blk in self.resblocks:
            x = blk(x, train)
        x = self.ln_post(x)
        return x @ cached_cast(self, "proj", dt)
