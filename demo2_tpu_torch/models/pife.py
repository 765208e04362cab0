"""PIFE, the backbone wrapper, CLIP branch (demo2_tpu/models/pife.py).

The three modalities run as ONE stacked batch of 3B images, modality-major;
the camera ids are tiled over the modalities and their SIE embedding goes to
the CLS token; a (3,) or (B, 3) modality mask multiplies the images inside
the same forward, so every missing-modality setting shares the graph.
Returns patch tokens (3, B, N, C) and CLS features (3, B, C).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .. import not_ported
from ..ops.linear import make_param, truncated_normal_init
from .clip_vit import CLIPVisionTransformer

NUM_MODALITIES = 3  # RGB, NIR, TIR


def patch_grid_for(img_size, stride_size) -> Tuple[int, int]:
    """Token grid of the ViT family's VALID 16-kernel patch conv."""
    (h, w), (sh, sw) = img_size, stride_size
    return (h - 16) // sh + 1, (w - 16) // sw + 1


class PIFE(nn.Module):
    def __init__(self, *, transformer_type: str, img_size, stride_size, camera_num: int,
                 sie_camera: bool, sie_coe: float, dtype: torch.dtype, fused: bool,
                 depth_override: int, width_override: int, heads_override: int,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        if "ViT-B-16" not in transformer_type:
            raise not_ported(f"TRANSFORMER_TYPE {transformer_type!r}", "other backbones")
        self.sie_coe = sie_coe
        self.width = 768 if width_override < 0 else width_override
        depth = 12 if depth_override < 0 else depth_override
        heads = self.width // 64 if heads_override < 0 else heads_override
        self.cv_embed = None
        if sie_camera and camera_num > 0:
            self.cv_embed = make_param((camera_num, 768), truncated_normal_init(1e-6),
                                       generator=generator, device=device)
        gh, gw = patch_grid_for(img_size, stride_size)
        self.base = CLIPVisionTransformer(
            gh, gw, stride_size=stride_size[0], width=self.width, layers=depth, heads=heads,
            dtype=dtype, fused=fused, device=device, generator=generator,
        )

    def forward(self, images: torch.Tensor, cam_label: Optional[torch.Tensor] = None,
                modality_mask: Optional[torch.Tensor] = None):
        """images (B, 3, H, W, 3): [batch, modality, H, W, channel]."""
        b = images.shape[0]
        m = NUM_MODALITIES
        if modality_mask is not None:
            mask = modality_mask.to(images.dtype)
            if mask.ndim == 1:
                mask = mask[None, :]
            images = images * mask[:, :, None, None, None]
        x = images.transpose(0, 1).reshape(m * b, *images.shape[2:])
        cv_emb = None
        if self.cv_embed is not None and cam_label is not None:
            cv_emb = self.sie_coe * self.cv_embed[cam_label.long().repeat(m)]
            cv_emb = cv_emb[:, : self.width]
        tokens = self.base(x, cv_emb)
        tokens = tokens.reshape(m, b, *tokens.shape[1:])
        return tokens[:, :, 1:], tokens[:, :, 0]
