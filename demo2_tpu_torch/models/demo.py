"""DeMo, the flagship branch: backbone (CLIP ViT-B/16 or the ImageNet ViT
family) -> SDTPS -> DGAF v3 -> BNNeck head (demo2_tpu/models/demo.py::DeMo,
branch 4 with the SDTPS selector, make_model.py:872-962 of the reference), at
eval and in training.

The output contract is the JAX package's: {"branches": {name: (logits,
feat)}, "embedding": f32 (B, 3C), "aux_loss": {}}.  Every configuration
outside the ported slices raises NotImplementedError naming its ROADMAP item.
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


def train_slice_error(cfg: Config, model_only: bool = False):
    """The error for a training configuration outside the training slice, or
    None.  The model's training forward raises the model's part
    (`model_only`), create_train_state and build_train_step all of it."""
    t, m = cfg.TPU, cfg.MODEL
    if t.REMAT_BACKBONE:
        return not_ported("TPU.REMAT_BACKBONE", "the rest of the modules (REMAT_BACKBONE)")
    if model_only:
        return None
    if t.PIPELINED_AUGMENT:
        return not_ported("TPU.PIPELINED_AUGMENT", "the rest of the modules (not ported)")
    if "center" in m.METRIC_LOSS_TYPE:
        return not_ported(f"MODEL.METRIC_LOSS_TYPE={m.METRIC_LOSS_TYPE!r} (center loss)",
                          "the rest of the modules (center loss)")
    if t.ENABLE_COSINE_SCHEDULE and cfg.SOLVER.LR_SCHEDULER == "cosine":
        return not_ported("the cosine LR schedule", "the rest of the modules (timm_cosine_lr)")
    if t.NUM_DEVICES > 1:
        return not_ported(f"TPU.NUM_DEVICES={t.NUM_DEVICES}",
                          "the rest of the modules (parallel/ as DDP / NCCL)")
    if t.DATA_CACHE != "device":
        return not_ported(f"TPU.DATA_CACHE={t.DATA_CACHE!r} (the host loader)",
                          "eval entry points and datasets")
    return None


class DeMo(nn.Module):
    def __init__(self, cfg: Config, num_classes: int, camera_num: int, view_num: int = 0, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        check_slice(cfg)
        self.train_error = train_slice_error(cfg, model_only=True)
        m = cfg.MODEL
        dtype = compute_dtype(cfg)
        self.dtype = dtype
        self.num_classes = num_classes
        self.direct = bool(m.DIRECT)
        self.feat_dim = feat_dim_for(m.TRANSFORMER_TYPE)
        kw = dict(device=device, generator=generator)
        self.backbone = PIFE(
            transformer_type=m.TRANSFORMER_TYPE,
            img_size=tuple(cfg.INPUT.SIZE_TRAIN),
            stride_size=tuple(m.STRIDE_SIZE),
            camera_num=camera_num,
            view_num=view_num,
            sie_camera=m.SIE_CAMERA,
            sie_view=m.SIE_VIEW,
            sie_coe=m.SIE_COE,
            drop_path=m.DROP_PATH,
            drop_rate=m.DROP_OUT,
            attn_drop_rate=m.ATT_DROP_RATE,
            dtype=dtype,
            fused=cfg.TPU.USE_FLASH_ATTENTION,
            pallas_ln_bwd=cfg.TPU.PALLAS_LN_BWD,
            fused_mlp_train=cfg.TPU.FUSED_MLP_TRAIN,
            depth_override=cfg.TPU.BACKBONE_DEPTH,
            width_override=cfg.TPU.BACKBONE_WIDTH,
            heads_override=cfg.TPU.BACKBONE_HEADS,
            **kw,
        )
        if self.backbone.feat_dim != self.feat_dim:
            # JAX builds SDTPS / DGAF at feat_dim_for's width whatever the
            # backbone gives, and its forward then fails to broadcast (the
            # 384-wide deit_small / swin alias, or BACKBONE_WIDTH on an
            # ImageNet type); the port refuses the same configurations.
            raise ValueError(
                f"TRANSFORMER_TYPE {m.TRANSFORMER_TYPE!r}: the backbone gives "
                f"{self.backbone.feat_dim}-wide tokens, DeMo's modules take feat_dim_for's "
                f"{self.feat_dim}")
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
                view_label: Optional[torch.Tensor] = None,
                modality_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """images (B, 3, H, W, 3), cam_label and view_label (B,), modality_mask
        (3,) or (B, 3).  `train` selects batch statistics in the BNNecks,
        dropout and drop path (drawn from `generator`) and the training
        kernels of the backbone.  The JAX model's return_pattern acts only on
        a branch not ported yet (the 'moe' embedding)."""
        if train and self.train_error is not None:
            raise self.train_error
        patches, globals_ = self.backbone(images.to(self.dtype), cam_label, view_label,
                                          modality_mask, train, generator)
        enh, _ = self.sdtps(patches, globals_, train, generator)
        dgaf_feat = self.dgaf(enh)
        branches = {"dgaf": (self.head_dgaf(dgaf_feat, train), dgaf_feat)}
        if not self.direct:
            for i, nm in enumerate(("r", "n", "t")):
                head = getattr(self, f"head_{nm}")
                branches[f"ori_{nm}"] = (head(globals_[i], train), globals_[i])
        return {"branches": branches, "embedding": dgaf_feat.float(), "aux_loss": {}}
