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
sub-block's kernels); not ln_pre / ln_post.  With `remat`
(cfg.TPU.REMAT_BACKBONE) each block of a training forward runs under
torch.utils.checkpoint: its activations are not kept, and the backward runs
its forward again (the fused attention's kernel twice a step); eval never
recomputes.

The MambaPro tuning paths, as in the JAX package: LoRA on each block's
in-projection (`lora_rank`, `lora_enable`: ops/attention.py), its delta
merged into wqkv before the fused attention as before the plain MHA, and
ConvLoRA on the patch embed (`lora_conv`); the FFN adapter beside the unfused
MLP (`use_adapter`: x + mlp(ln_2(x)) + adapter_ffn(x)), which keeps the
fused MLP off at eval too; and the modality prompts (`use_prompt`): each
block appends 3k tokens to every modality segment of the stacked batch, its
own prompt at its modality's slot and the other two modalities' transferred
prompts at theirs, runs, strips them and hands their mean to the next block
as `last_prompt` (S = 129 + 12 in the block kernels at the flagship's size).
With `int8_mlp` (cfg.TPU.INT8_MLP) the MLP's two GEMMs run an int8 forward
and keep the exact backward (CLIPMlp, ops/quant.py); the fused MLP is then
off at eval too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.activations import quick_gelu
from ..ops.attention import MultiHeadAttention, conv_lora_delta
from ..ops.fused_block import fused_attention, fused_mlp, needs_grad
from ..ops.linear import (Linear, cached_cast, cached_merge, make_param, normal_init,
                          truncated_normal_init, uniform_init, zeros_init)
from ..ops.norm import LayerNorm
from ..ops.quant import int8_dense


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

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`weight` replaces the stored one (cast to the compute dtype): the
        CLIP tower's ConvLoRA merge."""
        dt = self.dtype
        weight = cached_cast(self, "weight", dt) if weight is None else weight
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), weight, cached_cast(self, "bias", dt),
                     stride=self.stride)
        return y.flatten(2).transpose(1, 2)


# TPU.INT8_MLP "static": the activation scale of both GEMMs, a rough
# calibration (ln_2's output and QuickGELU's reach |10|; clip_vit.py:77-81).
INT8_STATIC_SCALE = 10.0 / 127.0


class CLIPMlp(nn.Module):
    """c_proj(QuickGELU(c_fc(x))).  With `int8_fwd` "dynamic" or "static"
    (cfg.TPU.INT8_MLP) both GEMMs run ops/quant.py::int8_dense on the f32
    weights, dynamic or INT8_STATIC_SCALE activation scales, each bias added
    after the product in its dtype; the parameters are the same."""

    def __init__(self, width: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator, int8_fwd: str = "off"):
        super().__init__()
        self.int8_fwd = int8_fwd
        self.c_fc = Linear(width, 4 * width, dtype=dtype, device=device, generator=generator)
        self.c_proj = Linear(4 * width, width, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8_fwd == "off":
            return self.c_proj(quick_gelu(self.c_fc(x)))
        s = INT8_STATIC_SCALE if self.int8_fwd == "static" else 0.0
        y = int8_dense(x, self.c_fc.weight, s)
        y = quick_gelu(y + cached_cast(self.c_fc, "bias", y.dtype))
        y = int8_dense(y, self.c_proj.weight, s)
        return y + cached_cast(self.c_proj, "bias", y.dtype)


class FFNAdapter(nn.Module):
    """clip_vit.py::FFNAdapter: up(QuickGELU(down(x))), width -> width / 2 -> width."""

    def __init__(self, width: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.down = Linear(width, width // 2, dtype=dtype, device=device, generator=generator)
        self.up = Linear(width // 2, width, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(quick_gelu(self.down(x)))


PROMPT_K = 4  # prompt tokens per modality slot (clip_vit.py::ResidualAttentionBlock.prompt_k)
MODALITY_ADAPTERS = ("adapter_r", "adapter_n", "adapter_t")


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x)) (+ adapter_ffn(x)
    with `use_adapter`).  With `use_prompt` the forward takes and returns
    the prompt carried between blocks; the first block has no transfer
    adapter, as JAX's creates it only where a prompt comes in."""

    def __init__(self, width: int, heads: int, *, dtype: torch.dtype, fused: bool,
                 device: torch.device, generator: torch.Generator,
                 pallas_ln_bwd: bool = False, fused_mlp_train: bool = False,
                 lora_rank: int = 0, lora_enable=(True, True, True), use_adapter: bool = False,
                 use_prompt: bool = False, first: bool = True, int8_mlp: str = "off"):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.fused = fused
        self.fused_mlp_train = fused_mlp_train
        self.use_adapter = use_adapter
        self.use_prompt = use_prompt
        self.int8_mlp = int8_mlp
        kw = dict(dtype=dtype, device=device, generator=generator)
        # Fused, ln_1's parameters go to the attention kernels, never through
        # this module's forward.
        self.ln_1 = LayerNorm(width, device=device, pallas_bwd=pallas_ln_bwd and not fused)
        self.attn = MultiHeadAttention(width, heads, lora_rank=lora_rank,
                                       lora_enable=lora_enable, **kw)
        self.ln_2 = LayerNorm(width, device=device, pallas_bwd=pallas_ln_bwd)
        self.mlp = CLIPMlp(width, int8_fwd=int8_mlp, **kw)
        if use_adapter:
            self.adapter_ffn = FFNAdapter(width, **kw)
        if use_prompt:
            self.adapter_prompts = make_param((3, PROMPT_K, width), zeros_init,
                                              generator=generator, device=device)
            for name in MODALITY_ADAPTERS:
                setattr(self, name, FFNAdapter(width, **kw))
            if not first:
                self.adapter_transfer = FFNAdapter(width, **kw)

    def _append_prompts(self, x: torch.Tensor, last_prompt: Optional[torch.Tensor]):
        """x (3B, S, C), modality-major, -> (3B, S + 3k, C): segment m gets
        [slot 0, slot 1, slot 2], its own prompt at slot m, the other slots
        the transferred prompt_i + adapter_i(prompt_i) (clip_vit.py:206-233)."""
        k = PROMPT_K
        b3, _, c = x.shape
        b = b3 // 3
        prompts = cached_cast(self, "adapter_prompts", self.dtype)
        transferred = torch.stack([prompts[i] + getattr(self, name)(prompts[i])
                                   for i, name in enumerate(MODALITY_ADAPTERS)])
        if last_prompt is None:
            own = prompts[:, None].expand(3, b, k, c)
        else:
            lp = last_prompt.reshape(3, b, k, c)
            own = lp + self.adapter_transfer(lp) + prompts[:, None]
        tr = transferred[:, None].expand(3, b, k, c)
        segments = [torch.cat([own[m] if i == m else tr[i] for i in range(3)], dim=1)
                    for m in range(3)]
        return torch.cat([x, torch.cat(segments).to(x.dtype)], dim=1)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fused:
            return x + self.attn(self.ln_1(x))
        dt = self.dtype
        attn = self.attn
        params = (self.ln_1.weight, self.ln_1.bias, attn.qkv_weight(torch.float32),
                  attn.in_proj_bias, attn.out_proj.weight, attn.out_proj.bias)
        if not needs_grad(x, *params):  # eval: the weights' cached casts
            params = (params[0], params[1], attn.qkv_weight(dt), params[3],
                      cached_cast(attn.out_proj, "weight", dt), params[5])
        return fused_attention(x, *params, num_heads=self.heads,
                               scale=(x.shape[-1] // self.heads) ** -0.5)

    def _mlp(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        # The MLP is fused where JAX fuses it (clip_vit.py:250, :265): outside
        # training, and in training with TPU.FUSED_MLP_TRAIN, never beside the
        # adapter nor under TPU.INT8_MLP (whose eval must run training's int8
        # MLP).  JAX's fused MLP is differentiable wherever it runs, so an
        # input gradient taken outside training (a saliency map) goes through
        # FusedMlpBlockFn.
        if (not self.fused or (train and not self.fused_mlp_train) or self.use_adapter
                or self.int8_mlp != "off"):
            y = self.mlp(self.ln_2(x))
            if self.use_adapter:
                y = y + self.adapter_ffn(x)
            return x + y
        dt = self.dtype
        mlp = self.mlp
        params = (self.ln_2.weight, self.ln_2.bias, mlp.c_fc.weight, mlp.c_fc.bias,
                  mlp.c_proj.weight, mlp.c_proj.bias)
        if not needs_grad(x, *params):  # eval: the weights' cached casts
            params = (params[0], params[1], cached_cast(mlp.c_fc, "weight", dt), params[3],
                      cached_cast(mlp.c_proj, "weight", dt), params[5])
        return fused_mlp(x, *params)

    def forward(self, x: torch.Tensor, last_prompt: Optional[torch.Tensor] = None,
                train: bool = False):
        """x (3B, S, C) -> x, or with `use_prompt` (x, the (3B, k, C) mean of
        the three prompt slots' outputs) (clip_vit.py:275-280)."""
        if self.use_prompt:
            x = self._append_prompts(x, last_prompt)
        x = self._mlp(self._attention(x), train)
        if not self.use_prompt:
            return x
        k = PROMPT_K
        tail = x[:, -3 * k:]
        return x[:, :-3 * k], (tail[:, :k] + tail[:, k:2 * k] + tail[:, 2 * k:]) / 3.0


class CLIPVisionTransformer(nn.Module):
    def __init__(self, h_resolution: int, w_resolution: int, *, stride_size: int,
                 width: int, layers: int, heads: int, dtype: torch.dtype, fused: bool,
                 device: torch.device, generator: torch.Generator,
                 patch_size: int = 16, output_dim: int = 512, pallas_ln_bwd: bool = False,
                 fused_mlp_train: bool = False, remat: bool = False, lora_rank: int = 0,
                 lora_enable=(True, True, True), lora_conv: bool = False,
                 use_adapter: bool = False, use_prompt: bool = False, int8_mlp: str = "off"):
        super().__init__()
        self.width = width
        self.dtype = dtype
        self.remat = remat
        self.use_prompt = use_prompt
        self.patch_size = patch_size
        scale = width ** -0.5
        kw = dict(generator=generator, device=device)
        self.conv1 = PatchConv(width, patch_size, stride_size, dtype=dtype, **kw)
        self.lora_conv = bool(lora_conv and lora_rank > 0)
        if self.lora_conv:
            # ConvLoRA (clip_vit.py:325-348), the reference's layout: A
            # (r*k, 3*k) flax he_uniform (fan_in r*k), B (width*k, r*k) zeros.
            ks, r = patch_size, lora_rank
            self.conv_lora_a = make_param((r * ks, 3 * ks), uniform_init(math.sqrt(6.0 / (r * ks))),
                                          **kw)
            self.conv_lora_b = make_param((width * ks, r * ks), zeros_init, **kw)
        self.class_embedding = make_param((width,), normal_init(scale), **kw)
        self.positional_embedding = make_param(
            (h_resolution * w_resolution + 1, width), normal_init(scale), **kw)
        self.ln_pre = LayerNorm(width, device=device)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype=dtype, fused=fused, device=device,
                                   generator=generator, pallas_ln_bwd=pallas_ln_bwd,
                                   fused_mlp_train=fused_mlp_train, lora_rank=lora_rank,
                                   lora_enable=lora_enable, use_adapter=use_adapter,
                                   use_prompt=use_prompt, first=i == 0, int8_mlp=int8_mlp)
            for i in range(layers)
        )
        self.ln_post = LayerNorm(width, device=device)
        self.proj = make_param((width, output_dim), normal_init(scale), **kw)

    def patch_weight(self) -> Optional[torch.Tensor]:
        """The patch conv's weight with ConvLoRA's delta merged in, or None
        without ConvLoRA (the conv's own cached cast)."""
        if not self.lora_conv:
            return None
        w, a, b = self.conv1.weight, self.conv_lora_a, self.conv_lora_b
        return cached_merge(self, "conv1", (w, a, b), self.dtype, lambda: w + conv_lora_delta(
            a, b, self.width, 3, self.patch_size))

    def forward(self, x: torch.Tensor, cv_emb: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """x (B, H, W, 3) images, cv_emb (B, width) or None -> (B, N+1, output_dim)."""
        dt = self.dtype
        b = x.shape[0]
        x = self.conv1(x, self.patch_weight())
        cls = cached_cast(self, "class_embedding", dt).expand(b, 1, self.width)
        if cv_emb is not None:
            cls = cls + cv_emb.to(dt)[:, None, :]
        x = torch.cat([cls, x], dim=1) + cached_cast(self, "positional_embedding", dt)[None]
        x = self.ln_pre(x)
        last_prompt = None
        for blk in self.resblocks:
            if train and self.remat:
                out = checkpoint(blk, x, last_prompt, train, use_reentrant=False)
            else:
                out = blk(x, last_prompt, train)
            x, last_prompt = out if self.use_prompt else (out, None)
        x = self.ln_post(x)
        return x @ cached_cast(self, "proj", dt)
