"""PIFE, the backbone wrapper (demo2_tpu/models/pife.py): the CLIP branch, the
ImageNet ViT family, T2T-ViT and the CNN trunks (ResNet / IBN, OSNet / AIN).

The three modalities run as ONE stacked batch of 3B images, modality-major;
the camera (and view) ids are tiled over the modalities.  The CLIP branch
adds its SIE camera embedding to the CLS token; the ImageNet ViT and T2T add
their own to all tokens; the CNN trunks have none, and their tokens are the
map's global average followed by the flattened 16-stride map
(resnet.py::resnet_tokens), in their BatchNorms' training mode when `train`.
A (3,) or (B, 3) modality mask multiplies the images
inside the same forward, so every missing-modality setting shares the graph.
Returns patch tokens (3, B, N, C) and CLS features (3, B, C).  The CLIP
tower's tuning paths (LoRA, ConvLoRA, the FFN adapter, the modality prompts)
reach the CLIP branch only, as in the JAX package; MODEL.PROMPT on another
backbone raises as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.linear import make_param, truncated_normal_init
from .clip_vit import CLIPVisionTransformer
from .osnet import OSNET_AIN_VARIANTS, OSNET_CONFIGS, OSNet
from .resnet import RESNET_CONFIGS, ResNet, resnet_tokens
from .t2t import T2T_CONFIGS, T2TViT
from .vit import ImageNetViT

NUM_MODALITIES = 3  # RGB, NIR, TIR

# The ImageNet ViT family, first match wins (pife.py:249-275): name part ->
# (embed_dim, depth, heads, mlp_ratio, qkv_bias, qk_scale).  The
# 'swin_small' alias is the reference's plain 384-wide ViT, not a Swin.
IMAGENET_VITS = (
    ("vit_small", (768, 8, 8, 3.0, False, 768 ** -0.5)),
    ("swin", (384, 12, 6, 4.0, True, None)),
    ("deit_small", (384, 12, 6, 4.0, True, None)),
    ("vit_base", (768, 12, 12, 4.0, True, None)),
    ("deit_base", (768, 12, 12, 4.0, True, None)),
)


def imagenet_vit_config(transformer_type: str):
    for part, config in IMAGENET_VITS:
        if part in transformer_type:
            return config
    raise NotImplementedError(
        f"TRANSFORMER_TYPE '{transformer_type}' is not supported; use 'ViT-B-16' (CLIP), "
        "'vit_base_patch16_224', 'deit_base_patch16_224', 'deit_small_patch16_224', "
        "'vit_small_patch16_224', 't2t_vit_t_14' or 't2t_vit_t_24'. "
        "(swin is an unregistered dead mention in the reference.)"
    )


def patch_grid_for(transformer_type: str, img_size, stride_size) -> Tuple[int, int]:
    """Token grid (gh, gw) per backbone: the ViT family's VALID 16-kernel
    patch conv at the configured stride gives (H - 16) // s + 1 per side;
    T2T's three soft splits stride 16 in all; the CNN trunks are 16-stride
    with a ceil."""
    h, w = img_size
    if transformer_type.startswith("t2t"):
        return h // 16, w // 16
    if transformer_type.startswith(("resnet", "osnet")):
        return -(-h // 16), -(-w // 16)
    sh, sw = stride_size
    return (h - 16) // sh + 1, (w - 16) // sw + 1


class PIFE(nn.Module):
    def __init__(self, *, transformer_type: str, img_size, stride_size, camera_num: int,
                 sie_camera: bool, sie_coe: float, dtype: torch.dtype, fused: bool,
                 depth_override: int, width_override: int, heads_override: int,
                 device: torch.device, generator: torch.Generator, view_num: int = 0,
                 sie_view: bool = False, drop_path: float = 0.1, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, pallas_ln_bwd: bool = False,
                 fused_mlp_train: bool = False, remat: bool = False, lora_rank: int = 0,
                 lora_enable=(True, True, True), lora_conv: bool = False,
                 use_adapter: bool = False, use_prompt: bool = False):
        super().__init__()
        tt = transformer_type
        if use_prompt and "ViT-B-16" not in tt:
            raise NotImplementedError("MODEL.PROMPT is only defined for the CLIP backbone")
        self.transformer_type = tt
        self.width_override = width_override
        self.sie_coe = sie_coe
        self.cv_embed = None
        kw = dict(dtype=dtype, device=device, generator=generator)
        if "ViT-B-16" in tt:
            self.width = 768 if width_override < 0 else width_override
            depth = 12 if depth_override < 0 else depth_override
            heads = self.width // 64 if heads_override < 0 else heads_override
            if sie_camera and camera_num > 0:
                self.cv_embed = make_param((camera_num, 768), truncated_normal_init(1e-6),
                                           generator=generator, device=device)
            gh, gw = patch_grid_for(tt, img_size, stride_size)
            self.base = CLIPVisionTransformer(
                gh, gw, stride_size=stride_size[0], width=self.width, layers=depth,
                heads=heads, dtype=dtype, fused=fused, device=device, generator=generator,
                # the CLIP branch only, as in the JAX package
                pallas_ln_bwd=pallas_ln_bwd, fused_mlp_train=fused_mlp_train, remat=remat,
                lora_rank=lora_rank, lora_enable=lora_enable, lora_conv=lora_conv,
                use_adapter=use_adapter, use_prompt=use_prompt,
            )
            return
        if tt.startswith("resnet"):
            if tt not in RESNET_CONFIGS:
                raise NotImplementedError(
                    f"'{tt}': only the Bottleneck variants {sorted(RESNET_CONFIGS)} are ported "
                    "(resnet18/34 use BasicBlock and, like the rest of the CNN zoo, are dead "
                    "weight no reference code path can reach)")
            layers, ibn = RESNET_CONFIGS[tt]
            self.base = ResNet(layers, ibn=ibn, **kw)
            return
        if tt.startswith("osnet"):
            if tt not in OSNET_CONFIGS:
                raise NotImplementedError(f"'{tt}': ported widths are {sorted(OSNET_CONFIGS)}")
            layers, chans = OSNET_CONFIGS[tt]
            ain = tt.startswith("osnet_ain")
            self.base = OSNet(layers, chans, block_variants=OSNET_AIN_VARIANTS if ain else None,
                              conv1_in=ain, **kw)
            return
        vit_kw = dict(camera=camera_num if sie_camera else 0, view=view_num if sie_view else 0,
                      sie_xishu=sie_coe, drop_path_rate=drop_path, drop_rate=drop_rate,
                      attn_drop_rate=attn_drop_rate,
                      attn_implementation="pallas" if fused else "xla", remat=remat, **kw)
        if tt in T2T_CONFIGS:
            dim, depth, heads = T2T_CONFIGS[tt]
            self.base = T2TViT(
                img_size=tuple(img_size), embed_dim=dim if width_override < 0 else width_override,
                depth=depth if depth_override < 0 else depth_override,
                num_heads=heads if heads_override < 0 else heads_override, **vit_kw)
            return
        embed_dim, depth, heads, mlp_ratio, qkv_bias, qk_scale = imagenet_vit_config(tt)
        self.base = ImageNetViT(
            img_size=tuple(img_size), stride_size=tuple(stride_size),
            embed_dim=embed_dim if width_override < 0 else width_override,
            depth=depth if depth_override < 0 else depth_override,
            num_heads=heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
            **vit_kw,
        )

    @property
    def feat_dim(self) -> int:
        """Output width per modality (pife.py:93-114)."""
        tt = self.transformer_type
        if "ViT-B-16" in tt:
            return 512
        if tt in T2T_CONFIGS:
            return T2T_CONFIGS[tt][0] if self.width_override < 0 else self.width_override
        if "swin" in tt or "deit_small" in tt:
            return 384 if self.width_override < 0 else self.width_override
        if tt.startswith("resnet"):
            return 2048  # 512 x the Bottleneck's expansion
        if tt.startswith("osnet"):
            return OSNET_CONFIGS[tt][1][3]
        return 768 if self.width_override < 0 else self.width_override

    def forward(self, images: torch.Tensor, cam_label: Optional[torch.Tensor] = None,
                view_label: Optional[torch.Tensor] = None,
                modality_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """images (B, 3, H, W, 3): [batch, modality, H, W, channel]."""
        b = images.shape[0]
        m = NUM_MODALITIES
        if modality_mask is not None:
            mask = modality_mask.to(images.dtype)
            if mask.ndim == 1:
                mask = mask[None, :]
            images = images * mask[:, :, None, None, None]
        x = images.transpose(0, 1).reshape(m * b, *images.shape[2:])
        cams = None if cam_label is None else cam_label.long().repeat(m)
        if isinstance(self.base, CLIPVisionTransformer):
            cv_emb = None
            if self.cv_embed is not None and cams is not None:
                cv_emb = (self.sie_coe * self.cv_embed[cams])[:, : self.width]
            tokens = self.base(x, cv_emb, train)
        elif isinstance(self.base, (ResNet, OSNet)):
            g, t = resnet_tokens(self.base(x, train))
            tokens = torch.cat([g[:, None, :], t], dim=1)
        else:
            views = None if view_label is None else view_label.long().repeat(m)
            tokens = self.base(x, cams, views, train, generator)
        tokens = tokens.reshape(m, b, *tokens.shape[1:])
        return tokens[:, :, 1:], tokens[:, :, 0]
