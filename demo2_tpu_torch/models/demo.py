"""DeMo (demo2_tpu/models/demo.py::DeMo): the backbone (CLIP ViT-B/16 or
the ImageNet ViT family) and its four branches, selected by MODEL.USE_SDTPS
and MODEL.USE_DGAF as the JAX package selects them:
  1. neither: the Baseline, a head on the three globals (configs/*/Baseline.yml);
  2. SDTPS alone: the token mean or, with MODEL.GLOBAL_LOCAL, GlobalLocalFuse
     of SDTPS's output (DeMo_SDTPS.yml);
  3. DGAF alone: DGAF v3 over the patches or v1 over the (global-local
     fused) globals (DeMo_DGAF.yml);
  4. SDTPS + DGAF, the flagship (DeMo_SDTPS_DGAF.yml);
and, with MODEL.HDM or MODEL.ATM, the 'moe' branch of HDM + ATMoE beside
them (DeMo.yml), whose `return_pattern` picks the eval embedding: 1 the
three globals (3C), 2 the moe feature (7C), 3 both ([moe, ori], 10C).
At eval and in training.

The output contract is the JAX package's: {"branches": {name: (logits,
feat)} in the JAX package's order, "embedding": f32, "aux_loss": {}}.  Every
configuration outside the ported slices raises NotImplementedError naming
its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .. import not_ported
from ..config.defaults import Config, feat_dim_for
from .dgaf import DualGatedAdaptiveFusionV3, DualGatedPostFusion
from .hdm_atmoe import GeneralFusion
from .heads import ClassifierHead, GlobalLocalFuse
from .pife import PIFE
from .sdtps import MultiModalSDTPS


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


def token_selector(cfg: Config) -> Optional[str]:
    """MODEL.USE_FRCA's tri-state (demo2_tpu/models/demo.py::_token_selector):
    True selects FRCA, None follows USE_SDTPS, False selects neither."""
    m = cfg.MODEL
    if m.USE_FRCA is True:
        return "frca"
    return "sdtps" if m.USE_FRCA is None and m.USE_SDTPS else None


def check_slice(cfg: Config) -> None:
    """Raise for every configuration the port does not cover yet."""
    m = cfg.MODEL
    if m.ARCH in ("DeMo_Parallel", "DeMoBeiyong"):
        raise not_ported(f"MODEL.ARCH={m.ARCH!r}", "other DeMo branches and assemblies")
    if token_selector(cfg) == "frca":
        raise not_ported("MODEL.USE_FRCA=True (the FRCA selector)",
                         "other DeMo branches and assemblies (models/frca.py)")
    for flag, item in (
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
        self.selector = token_selector(cfg)
        self.use_dgaf = bool(m.USE_DGAF)
        self.use_moe = bool(m.HDM or m.ATM)
        c = self.feat_dim
        if self.selector == "sdtps":
            self.sdtps = MultiModalSDTPS(
                c, sparse_ratio=m.SDTPS_SPARSE_RATIO,
                use_cross_attn=m.SDTPS_CROSS_ATTN_TYPE == "attention",
                share_cross_attn_weights=m.SDTPS_SHARE_CROSS_ATTN, dtype=dtype, **kw)
        v3 = m.DGAF_VERSION == "v3"
        if self.use_dgaf and self.selector and not v3 and not m.GLOBAL_LOCAL:
            raise ValueError("DGAF V1 requires GLOBAL_LOCAL=True")  # as the JAX DeMo raises
        # GlobalLocalFuse feeds branch 2, and DGAF v1 in branches 3 and 4.
        self.global_local = bool(m.GLOBAL_LOCAL) and (
            bool(self.selector) and not self.use_dgaf or self.use_dgaf and not v3)
        if self.global_local:
            self.gl_fuse = GlobalLocalFuse(c, dtype=dtype, **kw)
        if self.use_dgaf:
            dgaf_kw = dict(tau=m.DGAF_TAU, init_alpha=m.DGAF_INIT_ALPHA, dtype=dtype, **kw)
            self.dgaf = (DualGatedAdaptiveFusionV3(c, num_heads=m.DGAF_NUM_HEADS, **dgaf_kw)
                         if v3 else DualGatedPostFusion(c, **dgaf_kw))
        if self.use_moe:
            self.general_fusion = GeneralFusion(c, use_atm=m.ATM, head=m.HEAD, dtype=dtype, **kw)

        # The branches in the JAX package's order, each with its head: the
        # selected branch's, the per-modality ones (DIRECT 0), the moe pair.
        self.main = "dgaf" if self.use_dgaf else self.selector or ("ori" if self.direct else None)
        self.branch_heads = {self.main: self.main} if self.main else {}
        if not self.direct:
            self.branch_heads.update({f"ori_{nm}": nm for nm in ("r", "n", "t")})
        if self.use_moe:
            self.branch_heads["moe"] = "moe"
            if self.direct:
                self.branch_heads.setdefault("ori", "ori")
        for branch, name in self.branch_heads.items():
            width = c if branch.startswith("ori_") else 7 * c if name == "moe" else 3 * c
            setattr(self, f"head_{name}", ClassifierHead(width, num_classes, **kw))

    @property
    def embed_dim(self) -> int:
        """The embedding's width at return_pattern 3, FeatureExtractor's."""
        return (10 if self.use_moe else 3) * self.feat_dim

    def forward(self, images: torch.Tensor, cam_label: Optional[torch.Tensor] = None,
                view_label: Optional[torch.Tensor] = None,
                modality_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_pattern: int = 3) -> Dict[str, Any]:
        """images (B, 3, H, W, 3), cam_label and view_label (B,), modality_mask
        (3,) or (B, 3).  `train` selects batch statistics in the BatchNorms,
        dropout and drop path (drawn from `generator`) and the training
        kernels of the backbone.  `return_pattern` picks the moe branch's
        embedding (1: ori, 2: moe, 3: [moe, ori]); without it, the embedding
        is the branch's feature."""
        if train and self.train_error is not None:
            raise self.train_error
        patches, globals_ = self.backbone(images.to(self.dtype), cam_label, view_label,
                                          modality_mask, train, generator)
        ori_feat = torch.cat(list(globals_), dim=-1)
        moe_feat = (self.general_fusion(patches, globals_, train, generator)
                    if self.use_moe else None)
        enh = self.sdtps(patches, globals_, train, generator)[0] if self.selector else patches
        if self.use_dgaf:  # branches 3 and 4
            feat = self._apply_dgaf_v3_or_v1(enh, globals_)
        elif self.selector:  # branch 2
            final = self.gl_fuse(enh, globals_) if self.global_local else enh.mean(2)
            feat = torch.cat(list(final), dim=-1)
        else:  # branch 1, the Baseline
            feat = ori_feat
        feats = {self.main: feat, "ori": ori_feat, "ori_r": globals_[0], "ori_n": globals_[1],
                 "ori_t": globals_[2], "moe": moe_feat}
        if not self.use_moe:
            embedding = feat
        elif return_pattern == 1:
            embedding = ori_feat
        elif return_pattern == 2:
            embedding = moe_feat
        else:
            embedding = torch.cat([moe_feat, ori_feat], dim=-1)
        branches = {branch: (getattr(self, f"head_{name}")(feats[branch], train), feats[branch])
                    for branch, name in self.branch_heads.items()}
        return {"branches": branches, "embedding": embedding.float(), "aux_loss": {}}

    def _apply_dgaf_v3_or_v1(self, enh: torch.Tensor, globals_: torch.Tensor) -> torch.Tensor:
        """DGAF v3 pools the (SDTPS-enhanced) tokens; v1 takes their
        GlobalLocalFuse, or the globals where GLOBAL_LOCAL is off (branch 3
        only: beside SDTPS v1 needs it, and the constructor raises JAX's
        ValueError)."""
        if isinstance(self.dgaf, DualGatedAdaptiveFusionV3):
            return self.dgaf(enh)
        return self.dgaf(self.gl_fuse(enh, globals_) if self.global_local else globals_)
