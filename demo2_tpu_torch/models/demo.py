"""The DeMo assemblies (demo2_tpu/models/demo.py: DeMo, DeMoParallel,
DeMoLegacy), each over the backbone (CLIP ViT-B/16 or the ImageNet ViT
family), at eval and in training.

DeMo has four branches, selected by the token selector (MODEL.USE_FRCA's
tri-state: FRCA, SDTPS or none) and MODEL.USE_DGAF as the JAX package
selects them:
  1. neither: the Baseline, a head on the three globals (configs/*/Baseline.yml);
  2. a selector alone: the token mean or, with MODEL.GLOBAL_LOCAL,
     GlobalLocalFuse of its output (DeMo_SDTPS.yml);
  3. DGAF alone: DGAF v3 over the patches or v1 over the (global-local
     fused) globals (DeMo_DGAF.yml);
  4. a selector + DGAF: the flagship (DeMo_SDTPS_DGAF.yml), or FRCA whose
     six directed cross-attentions between the modalities feed DGAF V3Multi
     (DeMo_FRCA_DGAF.yml, 6C);
and, with MODEL.HDM or MODEL.ATM, the 'moe' branch of HDM + ATMoE beside
them (DeMo.yml), whose `return_pattern` picks the eval embedding: 1 the
three globals (3C), 2 the moe feature (7C), 3 both ([moe, ori], 10C).
DeMoParallel (MODEL.ARCH 'DeMo_Parallel') runs SDTPS, DGAF v3 and
GlobalLocalFuse side by side, nine heads of width C, a 9C embedding.
DeMoLegacy (MODEL.ARCH 'DeMoBeiyong') cascades SACR or MultiModalSACR, then
Trimodal-LIF (its auxiliary loss 'lif' in training), then the optional
HDM + ATMoE head, SDTPS and DGAF.  MODEL.SDTPS_VARIANT 'complete' / 'fixed'
builds SDTPSComplete in SDTPS's place.

The output contract is the JAX package's: {"branches": {name: (logits,
feat)} in the JAX package's order, "embedding": f32, "aux_loss": {}}, and
"patches" where the forward took a `patch_perturb` probe.  Every training
configuration outside the ported slices raises NotImplementedError naming
its ROADMAP item (train_slice_error).  Under MODEL.FROZEN the build sets
requires_grad False on the frozen parameters (is_frozen); the optimizer
takes the others.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .. import not_ported
from ..config.defaults import Config, feat_dim_for
from ..ops.attention import MultiHeadAttention
from ..ops.norm import LayerNorm
from .dgaf import DualGatedAdaptiveFusionV3, DualGatedAdaptiveFusionV3Multi, DualGatedPostFusion
from .frca import FourierResidualChannelAttention
from .hdm_atmoe import GeneralFusion
from .heads import ClassifierHead, GlobalLocalFuse
from .lif import TrimodalLIF, lif_loss, lif_reweight
from .pife import PIFE, patch_grid_for
from .sacr import SACR, MultiModalSACR, MultiModalSACRv2
from .sdtps import MultiModalSDTPS
from .sdtps_variants import SDTPSComplete

MODALITIES = ("rgb", "nir", "tir")
# The FRCA bridge's directed (query, key) modality pairs, in the JAX order.
FRCA_PAIRS = ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


def token_selector(cfg: Config) -> Optional[str]:
    """MODEL.USE_FRCA's tri-state (demo2_tpu/models/demo.py::_token_selector):
    True selects FRCA, None follows USE_SDTPS, False selects neither."""
    m = cfg.MODEL
    if m.USE_FRCA is True:
        return "frca"
    return "sdtps" if m.USE_FRCA is None and m.USE_SDTPS else None


def is_frozen(name: str) -> bool:
    """MODEL.FROZEN's rule for a parameter name (reference LoRA.py
    mark_only_lora_as_trainable, JAX solver/optim.py:350-353): under
    backbone.base, and no name part containing "lora" or "adapter".  So the
    SIE embedding (backbone.cv_embed), the heads and fusion modules, every
    lora_* / conv_lora_* / adapter_* tensor and the prompts train; on the
    ImageNet ViT the whole base is frozen."""
    parts = name.split(".")
    return parts[:2] == ["backbone", "base"] and not any(
        "lora" in p or "adapter" in p for p in parts)


def train_slice_error(cfg: Config):
    """The error for a training configuration outside the training slice, or
    None; create_train_state and build_train_step raise it."""
    t = cfg.TPU
    if t.PIPELINED_AUGMENT:
        return not_ported("TPU.PIPELINED_AUGMENT", "the rest of the modules (not ported)")
    if t.NUM_DEVICES > 1:
        return not_ported(f"TPU.NUM_DEVICES={t.NUM_DEVICES}",
                          "the rest of the modules (parallel/ as DDP / NCCL)")
    return None


def make_sdtps(cfg: Config, feat_dim: int, **kw) -> nn.Module:
    """SDTPS, or SDTPSComplete for MODEL.SDTPS_VARIANT 'complete' / 'fixed'."""
    m = cfg.MODEL
    use_cross_attn = m.SDTPS_CROSS_ATTN_TYPE == "attention"
    if m.SDTPS_VARIANT in ("complete", "fixed"):
        return SDTPSComplete(feat_dim, num_heads=m.SDTPS_CROSS_ATTN_HEADS,
                             sparse_ratio=m.SDTPS_SPARSE_RATIO, use_gumbel=m.SDTPS_USE_GUMBEL,
                             gumbel_tau=m.SDTPS_GUMBEL_TAU, use_cross_attn=use_cross_attn, **kw)
    return MultiModalSDTPS(feat_dim, sparse_ratio=m.SDTPS_SPARSE_RATIO,
                           use_cross_attn=use_cross_attn, use_gumbel=m.SDTPS_USE_GUMBEL,
                           gumbel_tau=m.SDTPS_GUMBEL_TAU,
                           share_cross_attn_weights=m.SDTPS_SHARE_CROSS_ATTN, **kw)


def make_dgaf(cfg: Config, feat_dim: int, **kw) -> nn.Module:
    """DGAF v3 or v1 at MODEL.DGAF_VERSION."""
    m = cfg.MODEL
    dgaf_kw = dict(tau=m.DGAF_TAU, init_alpha=m.DGAF_INIT_ALPHA, **kw)
    if m.DGAF_VERSION == "v3":
        return DualGatedAdaptiveFusionV3(feat_dim, num_heads=m.DGAF_NUM_HEADS, **dgaf_kw)
    return DualGatedPostFusion(feat_dim, **dgaf_kw)


# The backbones whose own width DeMo's modules take (T2T-ViT, ResNet, OSNet).
OWN_WIDTH_BACKBONES = ("t2t", "resnet", "osnet")


class _Assembly(nn.Module):
    """The backbone, the heads and the output contract the assemblies share.
    A subclass sets `branch_heads` ({branch: head name}, in the JAX
    package's order) and calls `_add_heads` with each head's width."""

    def __init__(self, cfg: Config, num_classes: int, camera_num: int, view_num: int, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__()
        m = cfg.MODEL
        dtype = compute_dtype(cfg)
        self.dtype = dtype
        self.num_classes = num_classes
        self.direct = bool(m.DIRECT)
        self.feat_dim = feat_dim_for(m.TRANSFORMER_TYPE)
        kw = dict(device=device, generator=generator)
        self.grid = patch_grid_for(m.TRANSFORMER_TYPE, tuple(cfg.INPUT.SIZE_TRAIN),
                                   tuple(m.STRIDE_SIZE))
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
            remat=cfg.TPU.REMAT_BACKBONE,
            # the LoRA rank applies under FROZEN only (demo.py:98-100)
            lora_rank=cfg.TPU.LORA_RANK if m.FROZEN else 0,
            lora_enable=tuple(c in cfg.TPU.LORA_ENABLE for c in "qkv"),
            lora_conv=cfg.TPU.LORA_CONV,
            use_adapter=m.ADAPTER,
            use_prompt=m.PROMPT,
            int8_mlp=cfg.TPU.INT8_MLP,
            depth_override=cfg.TPU.BACKBONE_DEPTH,
            width_override=cfg.TPU.BACKBONE_WIDTH,
            heads_override=cfg.TPU.BACKBONE_HEADS,
            **kw,
        )
        if m.TRANSFORMER_TYPE.startswith(OWN_WIDTH_BACKBONES):
            # Deliberately unlike JAX (D6 in ROADMAP.md): DeMo's modules take
            # the width these backbones give, where JAX's feat_dim_for 768
            # fails to broadcast in SDTPS / DGAF.
            self.feat_dim = self.backbone.feat_dim
        if self.backbone.feat_dim != self.feat_dim:
            # JAX builds SDTPS / DGAF at feat_dim_for's width whatever the
            # backbone gives, and its forward then fails to broadcast (the
            # 384-wide deit_small / swin alias, or BACKBONE_WIDTH on an
            # ImageNet type); the port refuses the same configurations.
            raise ValueError(
                f"TRANSFORMER_TYPE {m.TRANSFORMER_TYPE!r}: the backbone gives "
                f"{self.backbone.feat_dim}-wide tokens, DeMo's modules take feat_dim_for's "
                f"{self.feat_dim}")
        if m.FROZEN:  # as the reference marks them at build time
            for name, p in self.named_parameters():
                if is_frozen(name):
                    p.requires_grad_(False)
        self.branch_heads: Dict[str, str] = {}

    def _add_heads(self, width_of, *, device: torch.device,
                   generator: torch.Generator) -> None:
        """A ClassifierHead per entry of `branch_heads`, `width_of(branch)` wide."""
        for branch, name in self.branch_heads.items():
            setattr(self, f"head_{name}", ClassifierHead(width_of(branch), self.num_classes,
                                                         device=device, generator=generator))

    def _features(self, images, cam_label, view_label, modality_mask, train, generator,
                  patch_perturb=None):
        """The backbone's (patches, globals); a `patch_perturb` (3, B, N, C)
        is added to the patches: with a zero-valued probe the forward is
        unchanged, and the gradient with respect to the probe is that of
        the patch tokens (Grad-CAM's, visualize/saliency.py::gradcam)."""
        patches, globals_ = self.backbone(images.to(self.dtype), cam_label, view_label,
                                          modality_mask, train, generator)
        if patch_perturb is not None:
            patches = patches + patch_perturb.to(patches.dtype)
        return patches, globals_

    def _output(self, feats: Dict[str, torch.Tensor], embedding: torch.Tensor, train: bool,
                aux_loss: Optional[Dict[str, torch.Tensor]] = None,
                patches: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """The output contract; "patches" (the probed patch tokens) only where
        the forward took a probe."""
        branches = {branch: (getattr(self, f"head_{name}")(feats[branch], train), feats[branch])
                    for branch, name in self.branch_heads.items()}
        out = {"branches": branches, "embedding": embedding.float(), "aux_loss": aux_loss or {}}
        if patches is not None:
            out["patches"] = patches
        return out


class DeMo(_Assembly):
    def __init__(self, cfg: Config, num_classes: int, camera_num: int, view_num: int = 0, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__(cfg, num_classes, camera_num, view_num, device=device,
                         generator=generator)
        m = cfg.MODEL
        dtype = self.dtype
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.selector = token_selector(cfg)
        self.use_dgaf = bool(m.USE_DGAF)
        self.use_moe = bool(m.HDM or m.ATM)
        c = self.feat_dim
        if self.selector == "sdtps":
            self.sdtps = make_sdtps(cfg, c, **kw)
        elif self.selector == "frca":
            for nm in MODALITIES:
                setattr(self, f"frca_{nm}",
                        FourierResidualChannelAttention(c, m.FRCA_NEGATIVE_SLOPE, **kw))
        v3 = m.DGAF_VERSION == "v3"
        if self.use_dgaf and self.selector and not v3 and not m.GLOBAL_LOCAL:
            raise ValueError("DGAF V1 requires GLOBAL_LOCAL=True")  # as the JAX DeMo raises
        # Branch 4's FRCA arm: six directed cross-attentions, one shared MHA,
        # into DGAF V3Multi over six token sets.
        self.frca_bridge = (self.selector == "frca" and self.use_dgaf and v3
                            and bool(m.FRCA_USE_CROSS_ATTN))
        # GlobalLocalFuse feeds branch 2, and DGAF v1 in branches 3 and 4.
        self.global_local = bool(m.GLOBAL_LOCAL) and (
            bool(self.selector) and not self.use_dgaf or self.use_dgaf and not v3)
        if self.global_local:
            self.gl_fuse = GlobalLocalFuse(c, **kw)
        if self.frca_bridge:
            self.frca_cross_attn = MultiHeadAttention(c, m.FRCA_CROSS_ATTN_HEADS, **kw)
            self.frca_cross_norm = LayerNorm(c, device=device)
            self.dgaf = DualGatedAdaptiveFusionV3Multi(
                c, num_heads=m.DGAF_NUM_HEADS, tau=m.DGAF_TAU, init_alpha=m.DGAF_INIT_ALPHA,
                num_modalities=len(FRCA_PAIRS), **kw)
        elif self.use_dgaf:
            self.dgaf = make_dgaf(cfg, c, **kw)
        if self.use_moe:
            self.general_fusion = GeneralFusion(c, use_atm=m.ATM, head=m.HEAD, **kw)

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
        main_width = (len(FRCA_PAIRS) if self.frca_bridge else 3) * c
        self._add_heads(lambda branch: c if branch.startswith("ori_") else 7 * c
                        if branch == "moe" else 3 * c if branch == "ori" else main_width,
                        device=device, generator=generator)

    @property
    def embed_dim(self) -> int:
        """The embedding's width at return_pattern 3, FeatureExtractor's."""
        if self.use_moe:
            return 10 * self.feat_dim
        return (len(FRCA_PAIRS) if self.frca_bridge else 3) * self.feat_dim

    def forward(self, images: torch.Tensor, cam_label: Optional[torch.Tensor] = None,
                view_label: Optional[torch.Tensor] = None,
                modality_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_pattern: int = 3,
                patch_perturb: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """images (B, 3, H, W, 3), cam_label and view_label (B,), modality_mask
        (3,) or (B, 3).  `train` selects batch statistics in the BatchNorms,
        dropout and drop path (drawn from `generator`) and the training
        kernels of the backbone.  `return_pattern` picks the moe branch's
        embedding (1: ori, 2: moe, 3: [moe, ori]); without it, the embedding
        is the branch's feature.  `patch_perturb` (3, B, N, C) is the probe
        of _features; the output then holds the probed patches too."""
        patches, globals_ = self._features(images, cam_label, view_label, modality_mask, train,
                                          generator, patch_perturb)
        ori_feat = torch.cat(list(globals_), dim=-1)
        moe_feat = (self.general_fusion(patches, globals_, train, generator)
                    if self.use_moe else None)
        if self.selector == "frca":
            enh = self._frca_stack(patches)
        elif self.selector:
            enh = self.sdtps(patches, globals_, train, generator)[0]
        else:
            enh = patches
        if self.frca_bridge:  # branch 4's FRCA arm
            feat = self._frca_cross(enh, train)
        elif self.use_dgaf:  # branches 3 and 4
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
        return self._output(feats, embedding, train,
                            patches=None if patch_perturb is None else patches)

    def _frca_stack(self, patches: torch.Tensor) -> torch.Tensor:
        """Each modality's patches through its own FRCA on the patch grid."""
        m, b, n, c = patches.shape
        return torch.stack([
            getattr(self, f"frca_{nm}")(patches[i].reshape(b, *self.grid, c)).reshape(b, n, c)
            for i, nm in enumerate(MODALITIES)])

    def _frca_cross(self, enh: torch.Tensor, train: bool) -> torch.Tensor:
        """The six directed cross-attentions in one call of the shared MHA,
        LayerNorm over the residual, then DGAF V3Multi: (B, 6C)."""
        q = torch.cat([enh[a] for a, _ in FRCA_PAIRS])
        kv = torch.cat([enh[k] for _, k in FRCA_PAIRS])
        out = self.frca_cross_norm(self.frca_cross_attn(q, kv, train=train) + q)
        return self.dgaf(out.reshape(len(FRCA_PAIRS), enh.shape[1], *enh.shape[2:]))

    def _apply_dgaf_v3_or_v1(self, enh: torch.Tensor, globals_: torch.Tensor) -> torch.Tensor:
        """DGAF v3 pools the (selector-enhanced) tokens; v1 takes their
        GlobalLocalFuse, or the globals where GLOBAL_LOCAL is off (branch 3
        only: beside a selector v1 needs it, and the constructor raises JAX's
        ValueError)."""
        if isinstance(self.dgaf, DualGatedAdaptiveFusionV3):
            return self.dgaf(enh)
        return self.dgaf(self.gl_fuse(enh, globals_) if self.global_local else globals_)


PARALLEL_FAMILIES = ("sdtps", "dgaf", "fused")


class DeMoParallel(_Assembly):
    """Three branch families side by side, each split by modality into three
    heads of width C (sdtps_rgb ... fused_tir): SDTPS's token mean, DGAF v3
    over the patches, GlobalLocalFuse.  The embedding is the nine features, 9C."""

    def __init__(self, cfg: Config, num_classes: int, camera_num: int, view_num: int = 0, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__(cfg, num_classes, camera_num, view_num, device=device,
                         generator=generator)
        m = cfg.MODEL
        c = self.feat_dim
        kw = dict(dtype=self.dtype, device=device, generator=generator)
        self.sdtps = make_sdtps(cfg, c, **kw)
        self.dgaf = DualGatedAdaptiveFusionV3(c, num_heads=m.DGAF_NUM_HEADS, tau=m.DGAF_TAU,
                                              init_alpha=m.DGAF_INIT_ALPHA, **kw)
        self.gl_fuse = GlobalLocalFuse(c, **kw)
        self.branch_heads = {f"{fam}_{nm}": f"{fam}_{nm}" for fam in PARALLEL_FAMILIES
                             for nm in MODALITIES}
        self._add_heads(lambda branch: c, device=device, generator=generator)

    @property
    def embed_dim(self) -> int:
        return len(self.branch_heads) * self.feat_dim

    def forward(self, images: torch.Tensor, cam_label: Optional[torch.Tensor] = None,
                view_label: Optional[torch.Tensor] = None,
                modality_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_pattern: int = 3,
                patch_perturb: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """DeMo.forward's arguments; `return_pattern` changes nothing here."""
        patches, globals_ = self._features(images, cam_label, view_label, modality_mask, train,
                                          generator, patch_perturb)
        m, b, n, c = patches.shape
        families = {
            "sdtps": self.sdtps(patches, globals_, train, generator)[0].mean(2),
            "dgaf": self.dgaf(patches).reshape(b, m, c).transpose(0, 1),
            "fused": self.gl_fuse(patches, globals_),
        }
        feats = {f"{fam}_{nm}": families[fam][i] for fam in PARALLEL_FAMILIES
                 for i, nm in enumerate(MODALITIES)}
        return self._output(feats, torch.cat(list(feats.values()), dim=-1), train,
                            patches=None if patch_perturb is None else patches)


class DeMoLegacy(_Assembly):
    """The 'DeMoBeiyong' cascade over the patches: SACR (shared, MODEL.USE_SACR)
    or MultiModalSACR v1 / v2 (MODEL.USE_MULTIMODAL_SACR), then Trimodal-LIF
    (MODEL.USE_LIF: the patches reweighted by the quality maps at temperature
    LIF_BETA * 10, the auxiliary loss 'lif' in training), then the moe head
    (MODEL.HDM / ATM, first among the branches), SDTPS and DGAF.  One main
    branch, in priority SDTPS + DGAF ('dgaf'), SDTPS, DGAF, the globals."""

    def __init__(self, cfg: Config, num_classes: int, camera_num: int, view_num: int = 0, *,
                 device: torch.device, generator: torch.Generator):
        super().__init__(cfg, num_classes, camera_num, view_num, device=device,
                         generator=generator)
        m = cfg.MODEL
        c = self.feat_dim
        kw = dict(dtype=self.dtype, device=device, generator=generator)
        sacr_args = (c, *self.grid, tuple(m.SACR_DILATION_RATES))
        if m.USE_MULTIMODAL_SACR:
            cls = MultiModalSACRv2 if m.MULTIMODAL_SACR_VERSION == "v2" else MultiModalSACR
            self.multimodal_sacr = cls(*sacr_args, **kw)
        elif m.USE_SACR:
            self.sacr = SACR(*sacr_args, **kw)
        self.use_lif = bool(m.USE_LIF)
        if self.use_lif:
            self.lif = TrimodalLIF(**kw)
            self.lif_temperature = m.LIF_BETA * 10.0
        self.use_moe = bool(m.HDM or m.ATM)
        if self.use_moe:
            self.general_fusion = GeneralFusion(c, use_atm=m.ATM, head=m.HEAD, **kw)
        self.use_sdtps, self.use_dgaf = bool(m.USE_SDTPS), bool(m.USE_DGAF)
        self.v3 = m.DGAF_VERSION == "v3"
        if self.use_sdtps:
            self.sdtps = make_sdtps(cfg, c, **kw)
        if self.use_sdtps and self.use_dgaf and not self.v3 and not m.GLOBAL_LOCAL:
            raise ValueError("SDTPS + DGAF V1 requires GLOBAL_LOCAL")  # as the JAX package
        # GlobalLocalFuse of SDTPS's output, or of the patches before DGAF v1.
        self.global_local = bool(m.GLOBAL_LOCAL) and (
            self.use_sdtps or self.use_dgaf and not self.v3)
        if self.global_local:
            self.gl_fuse = GlobalLocalFuse(c, **kw)
        if self.use_dgaf:
            self.dgaf = make_dgaf(cfg, c, **kw)

        self.main = ("dgaf" if self.use_dgaf else "sdtps" if self.use_sdtps
                     else "ori" if self.direct else None)
        self.branch_heads = {"moe": "moe"} if self.use_moe else {}
        if self.main:
            self.branch_heads[self.main] = self.main
        if not self.direct:
            self.branch_heads.update({f"ori_{nm}": nm for nm in ("r", "n", "t")})
        self._add_heads(lambda branch: c if branch.startswith("ori_") else 7 * c
                        if branch == "moe" else 3 * c, device=device, generator=generator)

    @property
    def embed_dim(self) -> int:
        return 3 * self.feat_dim

    def forward(self, images: torch.Tensor, cam_label: Optional[torch.Tensor] = None,
                view_label: Optional[torch.Tensor] = None,
                modality_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_pattern: int = 3,
                patch_perturb: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """DeMo.forward's arguments; `return_pattern` changes nothing here.
        LIF reads `images` as given, before the modality mask.  With a probe
        the output's "patches" are the backbone's, before the cascade."""
        patches, globals_ = self._features(images, cam_label, view_label, modality_mask, train,
                                          generator, patch_perturb)
        probed = None if patch_perturb is None else patches
        aux = {}
        for stage in ("multimodal_sacr", "sacr"):  # at most one is built
            if hasattr(self, stage):
                patches = getattr(self, stage)(patches, train)
        if self.use_lif:
            qmaps = self.lif(images.to(self.dtype), train)
            if train:
                aux["lif"] = lif_loss(qmaps, images)
            patches = lif_reweight(patches, qmaps, self.grid, self.lif_temperature)
        feats = {"ori": torch.cat(list(globals_), dim=-1), "ori_r": globals_[0],
                 "ori_n": globals_[1], "ori_t": globals_[2]}
        if self.use_moe:
            feats["moe"] = self.general_fusion(patches, globals_, train, generator)
        enh = final = None
        if self.use_sdtps:
            enh = self.sdtps(patches, globals_, train, generator)[0]
            if not self.use_dgaf or not self.v3:
                final = self.gl_fuse(enh, globals_) if self.global_local else enh.mean(2)
                feats["sdtps"] = torch.cat(list(final), dim=-1)
        if self.use_dgaf:
            if self.v3:
                feats["dgaf"] = self.dgaf(enh if self.use_sdtps else patches)
            elif self.use_sdtps:
                feats["dgaf"] = self.dgaf(final)
            else:
                feats["dgaf"] = self.dgaf(self.gl_fuse(patches, globals_) if self.global_local
                                          else globals_)
        return self._output(feats, feats[self.main or "ori"], train, aux, probed)
