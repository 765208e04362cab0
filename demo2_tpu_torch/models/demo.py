"""DeMo at eval, the flagship branch: CLIP backbone -> SDTPS -> DGAF v3 ->
BNNeck head (demo2_tpu/models/demo.py::DeMo, branch 4 with the SDTPS
selector, make_model.py:872-962 of the reference).

The output contract is the JAX package's: {"branches": {name: (logits,
feat)}, "embedding": f32 (B, 3C), "aux_loss": {}}.  Every configuration
outside this slice raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .. import not_ported
from ..config.defaults import Config, feat_dim_for
from .dgaf import DualGatedAdaptiveFusionV3
from .heads import ClassifierHead
from .pife import PIFE
from .sdtps import MultiModalSDTPS


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


def check_slice(cfg: Config) -> None:
    """Raise for every configuration the port does not cover yet."""
    m = cfg.MODEL
    if m.ARCH in ("DeMo_Parallel", "DeMoBeiyong"):
        raise not_ported(f"MODEL.ARCH={m.ARCH!r}", "other DeMo branches and assemblies")
    selector_is_sdtps = m.USE_FRCA is None and m.USE_SDTPS
    if not (selector_is_sdtps and m.USE_DGAF and m.DGAF_VERSION == "v3"):
        raise not_ported(
            "DeMo without the SDTPS selector + DGAF v3 branch "
            f"(USE_FRCA={m.USE_FRCA}, USE_SDTPS={m.USE_SDTPS}, USE_DGAF={m.USE_DGAF}, "
            f"DGAF_VERSION={m.DGAF_VERSION!r})",
            "other DeMo branches and assemblies",
        )
    for flag, item in (
        ("HDM", "other DeMo branches and assemblies"),
        ("ATM", "other DeMo branches and assemblies"),
        ("GLOBAL_LOCAL", "other DeMo branches and assemblies"),
        ("SDTPS_SHARE_CROSS_ATTN", "other DeMo branches and assemblies"),
        ("FROZEN", "the rest of the modules (LoRA / FROZEN)"),
        ("ADAPTER", "the rest of the modules (ADAPTER)"),
        ("PROMPT", "the rest of the modules (PROMPT)"),
    ):
        if getattr(m, flag):
            raise not_ported(f"MODEL.{flag}", item)
    if m.SDTPS_VARIANT != "active":
        raise not_ported(f"MODEL.SDTPS_VARIANT={m.SDTPS_VARIANT!r}",
                         "other DeMo branches and assemblies")
    if cfg.TPU.INT8_MLP != "off":
        raise not_ported(f"TPU.INT8_MLP={cfg.TPU.INT8_MLP!r}", "the rest of the modules")


class DeMo(nn.Module):
    def __init__(self, cfg: Config, num_classes: int, camera_num: int, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        check_slice(cfg)
        m = cfg.MODEL
        dtype = compute_dtype(cfg)
        self.dtype = dtype
        self.direct = bool(m.DIRECT)
        self.feat_dim = feat_dim_for(m.TRANSFORMER_TYPE)
        kw = dict(device=device, generator=generator)
        self.backbone = PIFE(
            transformer_type=m.TRANSFORMER_TYPE,
            img_size=tuple(cfg.INPUT.SIZE_TRAIN),
            stride_size=tuple(m.STRIDE_SIZE),
            camera_num=camera_num,
            sie_camera=m.SIE_CAMERA,
            sie_coe=m.SIE_COE,
            dtype=dtype,
            fused=cfg.TPU.USE_FLASH_ATTENTION,
            depth_override=cfg.TPU.BACKBONE_DEPTH,
            width_override=cfg.TPU.BACKBONE_WIDTH,
            heads_override=cfg.TPU.BACKBONE_HEADS,
            **kw,
        )
        self.sdtps = MultiModalSDTPS(
            self.feat_dim,
            sparse_ratio=m.SDTPS_SPARSE_RATIO,
            use_cross_attn=m.SDTPS_CROSS_ATTN_TYPE == "attention",
            dtype=dtype,
            **kw,
        )
        self.dgaf = DualGatedAdaptiveFusionV3(
            self.feat_dim, tau=m.DGAF_TAU, init_alpha=m.DGAF_INIT_ALPHA,
            num_heads=m.DGAF_NUM_HEADS, dtype=dtype, **kw,
        )
        self.head_dgaf = ClassifierHead(3 * self.feat_dim, num_classes, **kw)
        if not self.direct:
            for nm in ("r", "n", "t"):
                setattr(self, f"head_{nm}", ClassifierHead(self.feat_dim, num_classes, **kw))

    @property
    def embed_dim(self) -> int:
        return 3 * self.feat_dim

    def forward(self, images: torch.Tensor, cam_label: Optional[torch.Tensor] = None,
                modality_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> Dict[str, Any]:
        """images (B, 3, H, W, 3), cam_label (B,), modality_mask (3,) or (B, 3).
        The JAX model's view_label and return_pattern act only on branches
        not ported yet (SIE views, the 'moe' embedding)."""
        if train:
            raise not_ported("the training forward", "the training slice")
        patches, globals_ = self.backbone(images.to(self.dtype), cam_label, modality_mask)
        enh, _ = self.sdtps(patches, globals_)
        dgaf_feat = self.dgaf(enh)
        branches = {"dgaf": (self.head_dgaf(dgaf_feat), dgaf_feat)}
        if not self.direct:
            for i, nm in enumerate(("r", "n", "t")):
                branches[f"ori_{nm}"] = (getattr(self, f"head_{nm}")(globals_[i]), globals_[i])
        return {"branches": branches, "embedding": dgaf_feat.float(), "aux_loss": {}}
