"""Configuration tree of the PyTorch port.

A field-for-field copy of demo2_tpu/config/defaults.py, kept in the port so
that the port (and the on-card smoke run) imports nothing of the JAX
package.  tests/test_torch_package.py asserts that both trees have the same
fields and defaults, so one config object drives either package and
`TPU.USE_FLASH_ATTENTION` / `TPU.COMPUTE_DTYPE` mean the same in both: in the
port, USE_FLASH_ATTENTION selects the hand-written CUDA block kernels for
CUDA tensors.  `Config.merge_from_file` / `merge_from_list` load the YAML
files under configs/ and CLI opts (config/yaml_loader.py).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


class FrozenError(AttributeError):
    pass


class _Node:
    """Mutable-until-frozen config node with attribute access."""

    _frozen: bool = False

    def __setattr__(self, key, value):
        if getattr(self, "_frozen", False) and key != "_frozen":
            raise FrozenError(f"Config is frozen; cannot set {key}")
        object.__setattr__(self, key, value)

    def freeze(self):
        object.__setattr__(self, "_frozen", True)
        for v in self.__dict__.values():
            if isinstance(v, _Node):
                v.freeze()
        return self

    def defrost(self):
        object.__setattr__(self, "_frozen", False)
        for v in self.__dict__.values():
            if isinstance(v, _Node):
                v.defrost()
        return self

    def clone(self):
        return copy.deepcopy(self.defrost_copy())

    def defrost_copy(self):
        new = copy.deepcopy(self)
        new.defrost()
        return new

    def to_dict(self):
        out = {}
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            out[k] = v.to_dict() if isinstance(v, _Node) else v
        return out

    def __repr__(self):
        return f"{type(self).__name__}({self.to_dict()})"


def _node(cls):
    """Decorator: dataclass whose instances behave like yacs CfgNodes."""
    return dataclass(eq=True)(type(cls.__name__, (cls, _Node), dict(cls.__dict__)))


@_node
class ModelConfig:
    # Architecture selection (reference: config/defaults.py:9)
    ARCH: str = "DeMo"
    DEVICE: str = "tpu"
    DEVICE_ID: str = "0"
    NAME: str = "DeMo"
    PRETRAIN_PATH_T: str = ""
    NECK: str = "bnneck"
    IF_WITH_CENTER: str = "no"
    ID_LOSS_TYPE: str = "softmax"
    ID_LOSS_WEIGHT: float = 1.0
    TRIPLET_LOSS_WEIGHT: float = 1.0
    METRIC_LOSS_TYPE: str = "triplet"
    DIST_TRAIN: bool = False
    PROMPT: bool = False
    ADAPTER: bool = False
    FROZEN: bool = False
    # HDM / ATMoE (the original-paper path; reference: config/defaults.py:36-37)
    HDM: bool = False
    ATM: bool = False
    # SACR (reference: config/defaults.py:39-40)
    USE_SACR: bool = False
    SACR_DILATION_RATES: Tuple[int, ...] = (2, 3, 4)
    # SDTPS (reference: config/defaults.py:42-50)
    USE_SDTPS: bool = False
    SDTPS_SPARSE_RATIO: float = 0.5
    SDTPS_AGGR_RATIO: float = 0.4
    SDTPS_BETA: float = 0.25
    SDTPS_USE_GUMBEL: bool = False
    SDTPS_GUMBEL_TAU: float = 1.0
    SDTPS_LOSS_WEIGHT: float = 2.0
    SDTPS_CROSS_ATTN_TYPE: str = "cosine"
    SDTPS_CROSS_ATTN_HEADS: int = 4
    SDTPS_SHARE_CROSS_ATTN: bool = False
    # Selects the SDTPS implementation: "active" = modeling/sdtps.py (the
    # only one the reference ever imports); "complete"/"fixed" = the
    # byte-identical sdtps_complete.py/sdtps_fixed.py variant (multi-head
    # gated scorer + hard top-k), ported in models/sdtps_variants.py.
    SDTPS_VARIANT: str = "active"
    # Trimodal-LIF (reference: config/defaults.py:52-55)
    USE_LIF: bool = False
    LIF_BETA: float = 0.4
    LIF_LOSS_WEIGHT: float = 0.1
    LIF_LAYER: int = 3
    # DGAF (reference: config/defaults.py:58-63)
    USE_DGAF: bool = False
    DGAF_VERSION: str = "v3"
    DGAF_TAU: float = 1.0
    DGAF_INIT_ALPHA: float = 0.5
    DGAF_NUM_HEADS: int = 8
    # Set by scripts/dgaf_experiments.sh in the reference but ABSENT from its
    # yacs defaults (the suite as shipped would crash upstream).  Accepted
    # here so the recipe runs; routes to DGAF V2's cross-modal attention
    # toggle (dual_gated_fusion.py:290-403), the only variant with one.
    DGAF_USE_CROSS_ATTN: bool = False
    DGAF_LOSS_WEIGHT: float = 1.0
    # Exact-reference loss weighting for DeMo_Parallel: the reference engine's
    # generic loop only scales pair 0 (= sdtps_rgb) by SDTPS_LOSS_WEIGHT and
    # never applies the per-family weights it defines
    # (engine/processor.py:86-96).  True reproduces that quirk so loss
    # trajectories compare apples-to-apples; False (default) applies the
    # documented per-family weights.
    PARALLEL_LOSS_PARITY: bool = False
    # MultiModal SACR (reference: config/defaults.py:66-67)
    USE_MULTIMODAL_SACR: bool = False
    MULTIMODAL_SACR_VERSION: str = "v1"
    FUSED_LOSS_WEIGHT: float = 0.5
    # FRCA (reference: config/defaults.py:73-76)
    USE_FRCA: Optional[bool] = None
    FRCA_NEGATIVE_SLOPE: float = 0.1
    FRCA_USE_CROSS_ATTN: bool = False
    FRCA_CROSS_ATTN_HEADS: int = 8
    IF_LABELSMOOTH: str = "on"
    DIRECT: int = 1
    # Transformer settings (reference: config/defaults.py:83-89)
    DROP_PATH: float = 0.1
    DROP_OUT: float = 0.0
    ATT_DROP_RATE: float = 0.0
    TRANSFORMER_TYPE: str = "vit_base_patch16_224"
    STRIDE_SIZE: Tuple[int, int] = (16, 16)
    GLOBAL_LOCAL: bool = False
    HEAD: int = 12  # number of ATMoE heads
    # SIE (reference: config/defaults.py:92-94)
    SIE_COE: float = 3.0
    SIE_CAMERA: bool = True
    SIE_VIEW: bool = False
    NO_MARGIN: bool = True


@_node
class InputConfig:
    SIZE_TRAIN: Tuple[int, int] = (256, 128)
    SIZE_TEST: Tuple[int, int] = (256, 128)
    PROB: float = 0.5
    RE_PROB: float = 0.5
    PIXEL_MEAN: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    PIXEL_STD: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    PADDING: int = 10


@_node
class DatasetsConfig:
    NAMES: str = "RGBNT201"
    ROOT_DIR: str = "./data"


@_node
class DataloaderConfig:
    NUM_WORKERS: int = 4
    SAMPLER: str = "softmax_triplet"
    NUM_INSTANCE: int = 16
    # Native C++ JPEG decode/resize (native/dataloader.cpp).  "auto" uses it
    # whenever libd2tloader is built and all samples are on-disk JPEGs; "off"
    # forces the PIL/torchvision-exact path (the native bilinear resize is a
    # triangle-filter approximation, ~2/255 per pass — users chasing
    # bit-level eval parity with the reference transform set "off"); "on"
    # errors if the library is unavailable.
    NATIVE_DECODE: str = "auto"


@_node
class SolverConfig:
    OPTIMIZER_NAME: str = "SGD"
    MAX_EPOCHS: int = 120
    BASE_LR: float = 0.009
    LARGE_FC_LR: bool = False
    MOMENTUM: float = 0.9
    MARGIN: float = 0.3
    CLUSTER_MARGIN: float = 0.3
    CENTER_LR: float = 0.5
    CENTER_LOSS_WEIGHT: float = 0.0005
    RANGE_K: int = 2
    RANGE_MARGIN: float = 0.3
    RANGE_ALPHA: int = 0
    RANGE_BETA: int = 1
    RANGE_LOSS_WEIGHT: int = 1
    WEIGHT_DECAY: float = 0.0001
    WEIGHT_DECAY_BIAS: float = 0.0001
    GAMMA: float = 0.1
    STEPS: Tuple[int, ...] = (40, 70)
    WARMUP_FACTOR: float = 0.01
    WARMUP_ITERS: int = 10
    WARMUP_METHOD: str = "linear"
    LR_SCHEDULER: str = "cosine"
    COSINE_MARGIN: float = 0.5
    COSINE_SCALE: int = 30
    SEED: int = 1234
    CHECKPOINT_PERIOD: int = 10
    LOG_PERIOD: int = 10
    EVAL_PERIOD: int = 1
    IMS_PER_BATCH: int = 128


@_node
class TestConfig:
    IMS_PER_BATCH: int = 256
    RE_RANKING: str = "no"
    WEIGHT: str = ""
    NECK_FEAT: str = "before"
    FEAT_NORM: str = "yes"
    MISS: str = "None"
    FEAT: int = 0  # injected by train CLI (--fea_cft), reference: train_net.py:49


@_node
class TPUConfig:
    """TPU-only knobs (no reference counterpart)."""

    # Computation dtype for the backbone/fusion stack: 'bfloat16' or 'float32'.
    COMPUTE_DTYPE: str = "bfloat16"
    # Use the Pallas fused attention kernel when running on TPU.
    USE_FLASH_ATTENTION: bool = True
    # Data-parallel mesh axis size; -1 = use all local devices.
    NUM_DEVICES: int = -1
    # Remat (activation checkpointing) for the backbone blocks.
    REMAT_BACKBONE: bool = False
    # Donate train-state buffers in the jitted train step.
    DONATE_STATE: bool = True
    # Run CMC/mAP evaluation on device.
    EVAL_ON_DEVICE: bool = True
    # Backbone size overrides for tests/benchmarks (-1 = architecture default).
    BACKBONE_DEPTH: int = -1
    BACKBONE_WIDTH: int = -1
    BACKBONE_HEADS: int = -1
    # LoRA rank used when MODEL.FROZEN freezes the backbone.
    LORA_RANK: int = 4
    # Which packed-qkv sub-projections carry LoRA adapters (any subset of
    # "qkv").  "qkv" = the whole-matrix adapter; a proper subset switches to
    # the MergedLinear per-slice semantics (reference clip/LoRA.py:133-231).
    LORA_ENABLE: str = "qkv"
    # ConvLoRA on the patch-embed conv (reference clip/LoRA.py:231-298
    # semantics; dormant there like the rest of the vendored library).
    LORA_CONV: bool = False
    # Store Adam's FIRST moment in bf16 (second moment stays fp32) — halves
    # a third of the optimizer's HBM traffic at a small numerics cost.  OFF
    # by default: the reference trains with full-fp32 Adam state.
    BF16_MOMENTS: bool = False
    # Sub-bf16 experiment: int8 FORWARD for the CLIP backbone's MLP GEMMs,
    # exact bf16 backward (ops/quant.py; docs/PERF.md round-3 measurement).
    # "off" | "dynamic" (per-tensor max-abs act scale) | "static"
    # (calibration constants, perf-representative of the fast int8 mode).
    INT8_MLP: str = "off"
    # Use the Pallas fused MLP sub-block (LN2+fc1+QuickGELU+fc2+residual,
    # custom-VJP backward) during TRAINING too, not just eval.  Perf
    # experiment flag (docs/PERF.md round 4); numerics are mathematically
    # identical but not bit-identical to the unfused path (in-kernel f32
    # accumulation), so it is off by default.
    FUSED_MLP_TRAIN: bool = False
    # Fused Pallas LayerNorm BACKWARD for the backbone's unfused LNs (ln_2
    # on the training path): one HBM pass for dx+dscale+dbias instead of
    # XLA's two-fusion chain (ops/norm.py::layernorm_pallas_bwd).  Forward
    # graph unchanged; grads differ only by f32-accumulation rounding.
    # Perf experiment flag (docs/PERF.md round 4).
    PALLAS_LN_BWD: bool = False
    # Also store Adam's SECOND moment in bf16 (requires BF16_MOMENTS).
    # Riskier than the first moment: (1-b2)*g^2 increments sit near bf16's
    # mantissa resolution (see solver/optim.py::scale_by_adam_mixed).
    BF16_SECOND_MOMENT: bool = False
    # Make SOLVER.LR_SCHEDULER='cosine' functional using the exact recipe of
    # the reference's commented-out cosine factory path
    # (scheduler_factory.py:21-48).  OFF by default: the reference's factory
    # ignores the flag and always uses warmup-multistep.
    ENABLE_COSINE_SCHEDULE: bool = False
    # Input pipeline: 'host' re-decodes per epoch (reference DataLoader
    # semantics); 'device' decodes once into an HBM-resident uint8 cache and
    # runs the random augmentations in-graph (data/device_cache.py) — the
    # TPU-first path that decouples throughput from host decode (this host
    # has ONE core and tops out at ~108 samples/s of JPEG decode).
    DATA_CACHE: str = "host"
    # Chunked-scan dispatch: augment batch k+1 inside iteration k so the
    # VPU-bound augment can overlap the MXU-bound model step (bit-identical
    # trajectory; engine/train.py).  Measured on v5e (2026-08-19 A/B,
    # logs/r4): pipelining is a ~0.6% REGRESSION (566.2 vs 569.9 img/s) —
    # XLA already overlaps the in-scan augment with the step, and the
    # carried next-batch buffer only adds HBM traffic.  Default off; kept
    # for re-measurement on other topologies.
    PIPELINED_AUGMENT: bool = False


@_node
class Config:
    MODEL: Any = field(default_factory=ModelConfig)
    INPUT: Any = field(default_factory=InputConfig)
    DATASETS: Any = field(default_factory=DatasetsConfig)
    DATALOADER: Any = field(default_factory=DataloaderConfig)
    SOLVER: Any = field(default_factory=SolverConfig)
    TEST: Any = field(default_factory=TestConfig)
    TPU: Any = field(default_factory=TPUConfig)
    OUTPUT_DIR: str = "./test"

    # ---- yacs-compatible API (config/yaml_loader.py) ----
    def merge_from_file(self, path: str):
        from .yaml_loader import merge_yaml_file

        merge_yaml_file(self, path)
        return self

    def merge_from_list(self, opts: List[Any]):
        from .yaml_loader import merge_opts_list

        merge_opts_list(self, opts)
        return self


def get_cfg_defaults() -> Config:
    """Return a fresh mutable default config."""
    return Config()


def feat_dim_for(transformer_type: str) -> int:
    """Output feature dim per modality (reference: make_model.py:467-470)."""
    if "ViT-B-16" in transformer_type:
        return 512
    return 768
