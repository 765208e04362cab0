"""Reference (PyTorch DeMo2) checkpoint -> the port's model
(demo2_tpu/utils/ref_convert.py).

Lets a user of the reference framework carry trained weights over: every
`convert_*` function maps a reference module's state dict onto the flax
layout of the JAX package (stacked (3, 3) / (7,) parameter axes, packed qkv,
the flattened expert BatchNorm), exactly as JAX's copy does: they take a
flat dict of numpy arrays and return (params, batch_stats) nested dicts,
and import nothing but numpy, so the port keeps its own copy of them.
`graft` (utils/converters.py, imported here as JAX keeps it here) then maps
that layout onto the port's tensor names, as it maps any flax tree, and
copies the converted tensors in.

Name map (reference -> demo2_tpu), with reference definitions at:
  * modeling/sdtps.py:282-538 (MultiModalSDTPS)      -> models/sdtps.py
  * modeling/dual_gated_fusion.py:406-1170 (DGAF)    -> models/dgaf.py
  * modeling/moe/AttnMOE.py:94-225 (MoM/GeneralFusion) -> models/hdm_atmoe.py
  * modeling/sacr.py:27-119 / multimodal_sacr.py     -> models/sacr.py
  * modeling/trimodal_lif.py:45-75                   -> models/lif.py
  * modeling/FRCA.py:85-145                          -> models/frca.py
  * modeling/make_model.py:450-962 (DeMo) / :976-1206 (DeMo_Parallel)
                                                     -> models/demo.py

Conventions: torch ``nn.Linear.weight`` is (out, in) -> transposed flax
kernels; conv weights (O, I, H, W) -> (H, W, I, O); torch
``nn.MultiheadAttention.in_proj_weight`` (3C, C) -> (C, 3C) packed kernel.

`convert_demo` converts a backbone only where the checkpoint has the
ImageNet ViT's `BACKBONE.base.cls_token`; a CLIP-backbone checkpoint leaves
the CLIP tower uncovered, and `load_reference_checkpoint` refuses it, naming
the parameters, as JAX's does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .converters import graft, load_torch_state_dict

Tree = Dict[str, Any]


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w) -> np.ndarray:  # (O, I, H, W) -> (H, W, I, O)
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def _arr(w) -> np.ndarray:
    return np.asarray(w)


def _sub(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _merge(dst: Tree, src: Tree) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def _nest(*contributions: Tuple[Tree, Tree]) -> Tuple[Tree, Tree]:
    params: Tree = {}
    stats: Tree = {}
    for p, s in contributions:
        _merge(params, p)
        _merge(stats, s)
    return params, stats


def _at(name: str, tree: Tree) -> Tree:
    return {name: tree} if tree else {}


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------

def convert_linear(sd, prefix) -> Tree:
    """torch nn.Linear -> TorchLinear ({'Dense_0': {...}})."""
    out = {"kernel": _t(sd[prefix + "weight"])}
    if prefix + "bias" in sd:
        out["bias"] = _arr(sd[prefix + "bias"])
    return {"Dense_0": out}


def convert_dense(sd, prefix) -> Tree:
    """torch nn.Linear -> bare flax Dense params."""
    out = {"kernel": _t(sd[prefix + "weight"])}
    if prefix + "bias" in sd:
        out["bias"] = _arr(sd[prefix + "bias"])
    return out


def convert_ln(sd, prefix) -> Tree:
    return {"scale": _arr(sd[prefix + "weight"]), "bias": _arr(sd[prefix + "bias"])}


def convert_bn(sd, prefix, use_bias=True) -> Tuple[Tree, Tree]:
    """torch BatchNorm -> TorchBatchNorm (params, batch_stats)."""
    params = {"scale": _arr(sd[prefix + "weight"])}
    if use_bias:
        params["bias"] = _arr(sd[prefix + "bias"])
    stats = {
        "mean": _arr(sd[prefix + "running_mean"]),
        "var": _arr(sd[prefix + "running_var"]),
    }
    return params, stats


def convert_mha(sd, prefix) -> Tree:
    """torch nn.MultiheadAttention -> ops.attention.MultiHeadAttention."""
    return {
        "in_proj_kernel": _t(sd[prefix + "in_proj_weight"]),
        "in_proj_bias": _arr(sd[prefix + "in_proj_bias"]),
        "out_proj": {
            "kernel": _t(sd[prefix + "out_proj.weight"]),
            "bias": _arr(sd[prefix + "out_proj.bias"]),
        },
    }


def convert_merged_lora(lora_A, lora_B, enable, r: int, alpha: float) -> Tree:
    """Reference MergedLinear adapter tensors -> ops.attention layout.

    Reference (clip/LoRA.py:133-231): ``lora_A`` is (r*n_on, in) and
    ``lora_B`` (slice*n_on, r); slice g's weight delta is
    zero_pad(B_g @ A_g) * alpha/r added to the (out, in) torch weight.  Our
    packed kernel is (in, n*slice) with delta a_s @ b_s per enabled slice
    (ops/attention.merged_lora_delta), so a_s = A_g.T, b_s = B_g.T, and the
    alpha/r scaling is folded into b (the module has no scale of its own).
    """
    A = _arr(lora_A)
    B = _arr(lora_B)
    n_on = sum(bool(e) for e in enable)
    c_in = A.shape[1]
    sl = B.shape[0] // n_on
    a = np.stack([A[g * r : (g + 1) * r].T for g in range(n_on)])  # (n_on, in, r)
    b = np.stack([B[g * sl : (g + 1) * sl].T for g in range(n_on)])  # (n_on, r, sl)
    assert a.shape == (n_on, c_in, r), a.shape
    return {"lora_a": a, "lora_b": b * (alpha / r)}


def convert_conv_lora(lora_A, lora_B, r: int, alpha: float) -> Tree:
    """Reference ConvLoRA adapter -> clip_vit patch-embed layout.

    Reference (clip/LoRA.py:231-298): A (r*k, in*k), B (out*k, r*k), delta
    (B @ A).view(weight.shape) * alpha/r.  Our params keep the reference
    layout verbatim (ops/attention.conv_lora_delta does the
    reinterpretation as an OIHW kernel), so conversion is the
    identity with the alpha/r scaling folded into B.
    """
    return {
        "conv_lora_a": _arr(lora_A),
        "conv_lora_b": _arr(lora_B) * (alpha / r),
    }


def convert_embedding_lora(lora_A, lora_B, r: int, alpha: float) -> Tree:
    """Reference LoRA Embedding adapter -> clip_text token-LoRA layout.

    Reference (clip/LoRA.py:33-90): A (r, vocab), B (width, r), delta =
    A.T[ids] @ B.T * alpha/r — identical layout here; the scaling folds
    into lora_b.
    """
    return {
        "token_lora_a": _arr(lora_A),
        "token_lora_b": _arr(lora_B) * (alpha / r),
    }


def convert_bnneck(sd, prefix) -> Tuple[Tree, Tree]:
    """Reference BNNeck (BatchNorm1d, frozen-zero bias) -> BNNeck module."""
    p, s = convert_bn(sd, prefix, use_bias=False)
    return {"bn": p}, {"bn": s}


def convert_classifier_head(sd, bottleneck_prefix, classifier_prefix) -> Tuple[Tree, Tree]:
    """bottleneck_* + classifier_* -> ClassifierHead (make_model.py:640-664)."""
    np_, ns = convert_bnneck(sd, bottleneck_prefix)
    params = {
        "bottleneck": np_,
        "classifier": {"kernel": _t(sd[classifier_prefix + "weight"])},
    }
    return params, {"bottleneck": ns}


# ---------------------------------------------------------------------------
# fusion modules
# ---------------------------------------------------------------------------

# (modality m, guide g) -> reference CrossModalAttention attribute
# (modeling/sdtps.py:360-382).
_SDTPS_ATTN_NAMES = {
    (0, 0): "rgb_self_attn", (0, 1): "rgb_cross_nir", (0, 2): "rgb_cross_tir",
    (1, 0): "nir_cross_rgb", (1, 1): "nir_self_attn", (1, 2): "nir_cross_tir",
    (2, 0): "tir_cross_rgb", (2, 1): "tir_cross_nir", (2, 2): "tir_self_attn",
}
_SDTPS_SHARED_NAMES = {0: "rgb_shared_attn", 1: "nir_shared_attn", 2: "tir_shared_attn"}
_SPARSE_NAMES = ("rgb_sparse", "nir_sparse", "tir_sparse")


def convert_sdtps(sd, shared: bool = False, use_cross_attn: bool = True) -> Tuple[Tree, Tree]:
    """MultiModalSDTPS state dict -> models/sdtps.py stacked params."""
    params: Tree = {}
    if use_cross_attn:
        cols = 1 if shared else 3
        def gather(field):
            rows = []
            for m in range(3):
                row = []
                for g in range(cols):
                    name = (_SDTPS_SHARED_NAMES[m] if shared
                            else _SDTPS_ATTN_NAMES[(m, g)])
                    w = sd[f"{name}.{field}"]
                    row.append(_t(w) if field.endswith("weight") else _arr(w))
                rows.append(np.stack(row))
            return np.stack(rows)

        params["q_proj_kernel"] = gather("q_proj.weight")
        params["q_proj_bias"] = gather("q_proj.bias")
        params["k_proj_kernel"] = gather("k_proj.weight")
        params["k_proj_bias"] = gather("k_proj.bias")

    for i, nm in enumerate(_SPARSE_NAMES):
        pfx = f"{nm}.modal_weight_mlp."
        if pfx + "0.weight" not in sd:
            continue
        params[f"modal_weight_mlp_{i}"] = {
            "fc0": convert_dense(sd, pfx + "0."),
            "ln": convert_ln(sd, pfx + "1."),
            "fc1": convert_dense(sd, pfx + "4."),
            "fc2": convert_dense(sd, pfx + "6."),
        }
    return params, {}


def convert_dgaf_core(sd) -> Tree:
    """IEG+MIG+alpha fields shared by V1/V3/V4/V3Multi -> _DualGateCore."""
    return {
        "entropy_proj": convert_linear(sd, "entropy_proj."),
        "gate_fc0": convert_linear(sd, "gate_net.0."),
        "gate_ln": convert_ln(sd, "gate_net.1."),
        "gate_fc1": convert_linear(sd, "gate_net.3."),
        "alpha": _arr(sd["_alpha"]).reshape(()),
    }


def _convert_enhance(sd, prefix="modal_enhance.") -> Tree:
    return {"fc": convert_linear(sd, prefix + "0."), "ln": convert_ln(sd, prefix + "1.")}


def convert_dgaf_v1(sd) -> Tuple[Tree, Tree]:
    """DualGatedPostFusion (dual_gated_fusion.py:406-555)."""
    return {"core": convert_dgaf_core(sd), "modal_enhance": _convert_enhance(sd)}, {}


def convert_dgaf_v4(sd) -> Tuple[Tree, Tree]:
    """DualGatedAdaptiveFusionV4 (:748-902) — same field layout as V1."""
    return convert_dgaf_v1(sd)


def convert_dgaf_v3(sd) -> Tuple[Tree, Tree]:
    """DualGatedAdaptiveFusionV3 (:558-745): + attention pooling."""
    queries = np.concatenate(
        [_arr(sd[f"{nm}_query"]).reshape(1, 1, -1) for nm in ("rgb", "nir", "tir")]
    )
    params = {
        "pool": {
            "queries": queries,
            "attn_pool": convert_mha(sd, "attn_pool."),
            "attn_norm": convert_ln(sd, "attn_norm."),
        },
        "core": convert_dgaf_core(sd),
        "modal_enhance": _convert_enhance(sd),
    }
    return params, {}


def convert_dgaf_v3multi(sd, num_modalities: int = 6) -> Tuple[Tree, Tree]:
    """DualGatedAdaptiveFusionV3Multi (:905-1170): ParameterList queries."""
    queries = np.concatenate(
        [_arr(sd[f"queries.{i}"]).reshape(1, 1, -1) for i in range(num_modalities)]
    )
    params = {
        "pool": {
            "queries": queries,
            "attn_pool": convert_mha(sd, "attn_pool."),
            "attn_norm": convert_ln(sd, "attn_norm."),
        },
        "core": convert_dgaf_core(sd),
        "modal_enhance": _convert_enhance(sd),
    }
    return params, {}


def convert_dgaf_v2(sd) -> Tuple[Tree, Tree]:
    """DualGatedAdaptiveFusionV2 (:290-403): base-class IEG/MIG layout."""
    params: Tree = {
        "entropy_proj": convert_linear(sd, "entropy_gate.proj."),
        "gate_fc0": convert_linear(sd, "importance_gate.gate_net.0."),
        "gate_fc1": convert_linear(sd, "importance_gate.gate_net.2."),
        "fusion_fc": convert_linear(sd, "importance_gate.fusion_proj.0."),
        "fusion_ln": convert_ln(sd, "importance_gate.fusion_proj.1."),
        "alpha": _arr(sd["_alpha"]).reshape(()),
        "output_fc": convert_linear(sd, "output_proj.0."),
        "output_ln": convert_ln(sd, "output_proj.1."),
    }
    if "cross_attn.in_proj_weight" in sd:
        params["cross_attn"] = convert_mha(sd, "cross_attn.")
        params["cross_attn_norm"] = convert_ln(sd, "cross_attn_norm.")
    return params, {}


def _convert_conv_bn(sd, prefix) -> Tuple[Tree, Tree]:
    """Sequential(Conv2d(bias=False), BatchNorm2d, act) -> ConvBNReLU/SiLU."""
    bn_p, bn_s = convert_bn(sd, prefix + "1.")
    return (
        {"conv": {"kernel": _conv(sd[prefix + "0.weight"])}, "bn": bn_p},
        {"bn": bn_s},
    )


def convert_sacr_core(sd, num_atrous: int = 3) -> Tuple[Tree, Tree]:
    """SACR pyramid + ECA (modeling/sacr.py:53-82) -> _SACRCore."""
    parts = [("conv1x1", "conv1x1.")]
    parts += [(f"atrous_{i}", f"atrous_convs.{i}.") for i in range(num_atrous)]
    parts += [("fusion", "fusion.")]
    params: Tree = {}
    stats: Tree = {}
    for ours, theirs in parts:
        p, s = _convert_conv_bn(sd, theirs)
        params[ours] = p
        stats[ours] = s
    # torch Conv1d weight (1, 1, k) -> flax Conv kernel (k, 1, 1).
    params["channel_attn"] = {
        "kernel": np.asarray(sd["channel_attn.weight"]).transpose(2, 1, 0)
    }
    return params, stats


def convert_sacr(sd, num_atrous: int = 3) -> Tuple[Tree, Tree]:
    p, s = convert_sacr_core(sd, num_atrous)
    return {"core": p}, {"core": s}


def convert_multimodal_sacr(sd, num_atrous: int = 3) -> Tuple[Tree, Tree]:
    p, s = convert_sacr_core(sd, num_atrous)
    cp, cs = _convert_conv_bn(sd, "cross_modal_conv.")
    return {"core": p, "cross_modal": cp}, {"core": s, "cross_modal": cs}


def convert_multimodal_sacr_v2(sd, num_atrous: int = 3) -> Tuple[Tree, Tree]:
    p, s = convert_sacr_core(sd, num_atrous)
    params = {
        "core": p,
        "modal_embed": _arr(sd["modal_embed"]).reshape(3, 1, -1),
        "cross_modal_attn": convert_mha(sd, "cross_modal_attn."),
        "cross_modal_norm": convert_ln(sd, "cross_modal_norm."),
    }
    return params, {"core": s}


def convert_quality_predictor(sd) -> Tuple[Tree, Tree]:
    """QualityPredictor (trimodal_lif.py:45-75): net.{0,2,4} Conv blocks + head."""
    params: Tree = {}
    stats: Tree = {}
    for ours, theirs in (("c0", "net.0."), ("c1", "net.2."), ("c2", "net.4.")):
        bn_p, bn_s = convert_bn(sd, theirs + "bn.")
        params[ours] = {"conv": {"kernel": _conv(sd[theirs + "conv.weight"])}, "bn": bn_p}
        stats[ours] = {"bn": bn_s}
    params["head"] = {
        "kernel": _conv(sd["net.6.weight"]),
        "bias": _arr(sd["net.6.bias"]),
    }
    return params, stats


def convert_lif(sd) -> Tuple[Tree, Tree]:
    params: Tree = {}
    stats: Tree = {}
    for nm in ("rgb", "nir", "tir"):
        p, s = convert_quality_predictor(_sub(sd, f"{nm}_predictor."))
        params[f"{nm}_predictor"] = p
        stats[f"{nm}_predictor"] = s
    return params, stats


def convert_frca(sd) -> Tuple[Tree, Tree]:
    """FourierResidualChannelAttention (FRCA.py:85-145)."""
    params: Tree = {
        "clc3": {
            "conv0": {"kernel": _conv(sd["clc3.net.0.weight"])},
            "conv1": {"kernel": _conv(sd["clc3.net.2.weight"])},
        },
        "clc1_amp_conv0": {"kernel": _conv(sd["clc1_amp.0.weight"])},
        "clc1_amp_conv1": {"kernel": _conv(sd["clc1_amp.2.weight"])},
        "clc1_pha_conv0": {"kernel": _conv(sd["clc1_pha.0.weight"])},
        "clc1_pha_conv1": {"kernel": _conv(sd["clc1_pha.2.weight"])},
        "dnru": {
            # depthwise torch (C, 1, 3, 3) -> flax (3, 3, 1, C)
            "dwconv": {"kernel": np.asarray(sd["dnru.dwconv.weight"]).transpose(2, 3, 1, 0)},
            "gn": convert_ln(sd, "dnru.gn."),
        },
    }
    return params, {}


_HDM_SET_NAMES = ("r", "n", "t", "rn", "rt", "nt", "rnt")


def convert_hdm(sd) -> Tuple[Tree, Tree]:
    """GeneralFusion's 7 tokens + 7 nn.MultiheadAttention -> stacked HDM."""
    params = {
        "set_tokens": np.stack(
            [_arr(sd[f"{nm}_token"]).reshape(-1) for nm in _HDM_SET_NAMES]
        ),
        "in_proj_kernel": np.stack(
            [_t(sd[f"{nm}.in_proj_weight"]) for nm in _HDM_SET_NAMES]
        ),
        "in_proj_bias": np.stack(
            [_arr(sd[f"{nm}.in_proj_bias"]) for nm in _HDM_SET_NAMES]
        ),
        "out_proj_kernel": np.stack(
            [_t(sd[f"{nm}.out_proj.weight"]) for nm in _HDM_SET_NAMES]
        ),
        "out_proj_bias": np.stack(
            [_arr(sd[f"{nm}.out_proj.bias"]) for nm in _HDM_SET_NAMES]
        ),
    }
    return params, {}


def convert_atmoe(sd, head: int) -> Tuple[Tree, Tree]:
    """MoM (AttnMOE.py:94-121) -> ATMoE.

    The per-(head, expert) BatchNorm1d(d) modules flatten into ONE BN over
    7C channels with channel order (set-major, head, channel).
    """
    num_experts = 7
    lr_bn_p, lr_bn_s = convert_bn(sd, "gating_network.gate.linear_re.2.")
    params: Tree = {
        "linear_re_fc": convert_linear(sd, "gating_network.gate.linear_re.0."),
        "linear_re_bn": lr_bn_p,
        "gate_q": convert_linear(sd, "gating_network.gate.q_."),
        "gate_k": convert_linear(sd, "gating_network.gate.k_."),
    }
    stats: Tree = {"linear_re_bn": lr_bn_s}

    kernels, biases = [], []
    bn_fields: Dict[str, list] = {"weight": [], "bias": [], "running_mean": [], "running_var": []}
    for h in range(head):
        k_row, b_row = [], []
        for s in range(num_experts):
            pfx = f"experts.{h}.expertHead.{s}.mlp."
            k_row.append(_t(sd[pfx + "0.weight"]))
            b_row.append(_arr(sd[pfx + "0.bias"]))
        kernels.append(np.stack(k_row))
        biases.append(np.stack(b_row))
    params["expert_kernel"] = np.stack(kernels)  # (head, 7, d, d)
    params["expert_bias"] = np.stack(biases)  # (head, 7, d)

    for field, acc in bn_fields.items():
        for s in range(num_experts):
            for h in range(head):
                acc.append(_arr(sd[f"experts.{h}.expertHead.{s}.mlp.2.{field}"]))
    flat = {k: np.concatenate(v) for k, v in bn_fields.items()}
    params["expert_bn"] = {"scale": flat["weight"], "bias": flat["bias"]}
    stats["expert_bn"] = {"mean": flat["running_mean"], "var": flat["running_var"]}
    return params, stats


def convert_general_fusion(sd, head: int, use_atm: bool = True) -> Tuple[Tree, Tree]:
    hp, hs = convert_hdm(sd)
    params: Tree = {"hdm": hp}
    stats: Tree = {}
    if use_atm:
        mp, ms = convert_atmoe(_sub(sd, "moe."), head)
        params["moe"] = mp
        stats["moe"] = ms
    return params, stats


def convert_global_local(sd) -> Tuple[Tree, Tree]:
    """{rgb,nir,tir}_reduce stacks -> GlobalLocalFuse stacked params."""
    names = ("rgb_reduce.", "nir_reduce.", "tir_reduce.")
    params = {
        "ln_scale": np.stack([_arr(sd[n + "0.weight"]) for n in names]),
        "ln_bias": np.stack([_arr(sd[n + "0.bias"]) for n in names]),
        "kernel": np.stack([_t(sd[n + "1.weight"]) for n in names]),
        "bias": np.stack([_arr(sd[n + "1.bias"]) for n in names]),
    }
    return params, {}


# ---------------------------------------------------------------------------
# backbone + full model assemblies
# ---------------------------------------------------------------------------

def convert_imagenet_vit_backbone(sd) -> Tuple[Tree, Tree]:
    """Reference `Trans` ViT state dict (already prefix-stripped) ->
    ImageNetViT params, preserving the native grid (no pos-embed resize;
    converters.convert_imagenet_vit handles resizing pretrained grids)."""
    pos = np.asarray(sd["pos_embed"])
    params = {
        "patch_embed_proj": {
            "kernel": _conv(sd["patch_embed.proj.weight"]),
            "bias": _arr(sd["patch_embed.proj.bias"]),
        },
        "cls_token": _arr(sd["cls_token"]),
        "pos_embed": pos,
        "norm": convert_ln(sd, "norm."),
    }
    if "sie_embed" in sd:
        params["sie_embed"] = _arr(sd["sie_embed"])
    i = 0
    while f"blocks.{i}.attn.qkv.weight" in sd:
        blk = f"blocks.{i}."
        p = {
            "norm1": convert_ln(sd, blk + "norm1."),
            "norm2": convert_ln(sd, blk + "norm2."),
            "attn": {
                "qkv": {"kernel": _t(sd[blk + "attn.qkv.weight"])},
                "proj": convert_dense(sd, blk + "attn.proj."),
            },
            "mlp": {
                "fc1": convert_dense(sd, blk + "mlp.fc1."),
                "fc2": convert_dense(sd, blk + "mlp.fc2."),
            },
        }
        if blk + "attn.qkv.bias" in sd:
            p["attn"]["qkv"]["bias"] = _arr(sd[blk + "attn.qkv.bias"])
        params[f"blocks_{i}"] = p
        i += 1
    return params, {}


_HEAD_MAP_DEMO = {
    # ours -> (bottleneck prefix, classifier prefix) in the reference DeMo
    "head_ori": ("bottleneck.", "classifier."),
    "head_r": ("bottleneck_r.", "classifier_r."),
    "head_n": ("bottleneck_n.", "classifier_n."),
    "head_t": ("bottleneck_t.", "classifier_t."),
    "head_sdtps": ("bottleneck_sdtps.", "classifier_sdtps."),
    "head_frca": ("bottleneck_frca.", "classifier_frca."),
    "head_dgaf": ("bottleneck_dgaf.", "classifier_dgaf."),
    "head_moe": ("bottleneck_moe.", "classifier_moe."),
}


def convert_demo(sd, cfg) -> Tuple[Tree, Tree]:
    """Full reference DeMo/DeMoBeiyong state dict -> demo2_tpu DeMo params.

    Supports the ImageNet-ViT backbone ('vit_base_patch16_224' family).  The
    CLIP backbone converts via converters.convert_clip_visual and is grafted
    separately (it loads from the CLIP archive, not the DeMo checkpoint).
    """
    params: Tree = {}
    stats: Tree = {}

    # Backbone.
    if "BACKBONE.base.cls_token" in sd:
        bp, bs = convert_imagenet_vit_backbone(_sub(sd, "BACKBONE.base."))
        params["backbone"] = {"base": bp}
        if bs:
            stats["backbone"] = {"base": bs}
    if "BACKBONE.cv_embed" in sd:
        params.setdefault("backbone", {})["cv_embed"] = _arr(sd["BACKBONE.cv_embed"])[
            :, 0, :
        ]

    # Heads.
    for ours, (bpfx, cpfx) in _HEAD_MAP_DEMO.items():
        if bpfx + "weight" in sd:
            hp, hs = convert_classifier_head(sd, bpfx, cpfx)
            params[ours] = hp
            stats[ours] = hs

    # Global-local fuse (always constructed in the reference; only convert if
    # our model materializes it — merge handles missing keys gracefully).
    if "rgb_reduce.0.weight" in sd:
        gp, _ = convert_global_local(sd)
        params["gl_fuse"] = gp

    if any(k.startswith("sdtps.") for k in sd):
        sp, _ = convert_sdtps(
            _sub(sd, "sdtps."),
            shared=getattr(cfg.MODEL, "SDTPS_SHARE_CROSS_ATTN", False),
            use_cross_attn=cfg.MODEL.SDTPS_CROSS_ATTN_TYPE == "attention",
        )
        params["sdtps"] = sp

    if any(k.startswith("dgaf.") for k in sd):
        dsd = _sub(sd, "dgaf.")
        if cfg.MODEL.DGAF_VERSION == "v3":
            if "queries.0" in dsd:
                n_q = sum(1 for k in dsd if k.startswith("queries."))
                dp, _ = convert_dgaf_v3multi(dsd, n_q)
            else:
                dp, _ = convert_dgaf_v3(dsd)
        else:
            dp, _ = convert_dgaf_v1(dsd)
        params["dgaf"] = dp

    for nm in ("rgb", "nir", "tir"):
        if any(k.startswith(f"frca_{nm}.") for k in sd):
            fp, _ = convert_frca(_sub(sd, f"frca_{nm}."))
            params[f"frca_{nm}"] = fp
    if "frca_cross_attn.in_proj_weight" in sd:
        params["frca_cross_attn"] = convert_mha(sd, "frca_cross_attn.")
        params["frca_cross_norm"] = convert_ln(sd, "frca_cross_norm.")

    if any(k.startswith("generalFusion.") for k in sd):
        gp, gs = convert_general_fusion(
            _sub(sd, "generalFusion."), head=cfg.MODEL.HEAD, use_atm=cfg.MODEL.ATM
        )
        params["general_fusion"] = gp
        if gs:
            stats["general_fusion"] = gs

    # DeMoBeiyong extras: SACR / MultiModalSACR / LIF.
    if any(k.startswith("sacr.") for k in sd):
        n_at = len(cfg.MODEL.SACR_DILATION_RATES)
        pp, ss = convert_sacr(_sub(sd, "sacr."), n_at)
        params["sacr"] = pp
        stats["sacr"] = ss
    if any(k.startswith("multimodal_sacr.") for k in sd):
        n_at = len(cfg.MODEL.SACR_DILATION_RATES)
        msd = _sub(sd, "multimodal_sacr.")
        if cfg.MODEL.MULTIMODAL_SACR_VERSION == "v2":
            pp, ss = convert_multimodal_sacr_v2(msd, n_at)
        else:
            pp, ss = convert_multimodal_sacr(msd, n_at)
        params["multimodal_sacr"] = pp
        stats["multimodal_sacr"] = ss
    if any(k.startswith("lif.rgb_predictor") for k in sd):
        lp, ls = convert_lif(_sub(sd, "lif."))
        params["lif"] = lp
        stats["lif"] = ls

    return params, stats


_PARALLEL_HEADS = [
    ("head_sdtps_rgb", "sdtps_rgb"), ("head_sdtps_nir", "sdtps_nir"),
    ("head_sdtps_tir", "sdtps_tir"), ("head_dgaf_rgb", "dgaf_rgb"),
    ("head_dgaf_nir", "dgaf_nir"), ("head_dgaf_tir", "dgaf_tir"),
    ("head_fused_rgb", "fused_rgb"), ("head_fused_nir", "fused_nir"),
    ("head_fused_tir", "fused_tir"),
]


def convert_demo_parallel(sd, cfg) -> Tuple[Tree, Tree]:
    """Reference DeMo_Parallel (make_model.py:976-1206) -> DeMoParallel."""
    params: Tree = {}
    stats: Tree = {}
    if "BACKBONE.base.cls_token" in sd:
        bp, _ = convert_imagenet_vit_backbone(_sub(sd, "BACKBONE.base."))
        params["backbone"] = {"base": bp}
    if "BACKBONE.cv_embed" in sd:
        params.setdefault("backbone", {})["cv_embed"] = _arr(sd["BACKBONE.cv_embed"])[
            :, 0, :
        ]
    for ours, theirs in _PARALLEL_HEADS:
        hp, hs = convert_classifier_head(sd, f"bottleneck_{theirs}.", f"classifier_{theirs}.")
        params[ours] = hp
        stats[ours] = hs
    sp, _ = convert_sdtps(
        _sub(sd, "sdtps."),
        shared=getattr(cfg.MODEL, "SDTPS_SHARE_CROSS_ATTN", False),
        use_cross_attn=cfg.MODEL.SDTPS_CROSS_ATTN_TYPE == "attention",
    )
    params["sdtps"] = sp
    dp, _ = convert_dgaf_v3(_sub(sd, "dgaf."))
    params["dgaf"] = dp
    gp, _ = convert_global_local(sd)
    params["gl_fuse"] = gp
    return params, stats


def load_reference_checkpoint(model, path: str, cfg) -> list:
    """Load a reference-trained torch ``.pth`` / ``.pt`` DeMo checkpoint (the
    reference's ``torch.save(model.state_dict())`` files) into `model` in
    place: the one-call migration path of tools/train.py's --init_pth and
    tools/test.py's .pth TEST.WEIGHT.  Dispatches on MODEL.ARCH as
    models/factory.py does: DeMo_Parallel through convert_demo_parallel, any
    other through convert_demo.  Every parameter of the model must be
    covered; converted tensors the model lacks are skipped; BatchNorm
    statistics are copied too.  Returns the names filled."""
    sd = {k: v.numpy() for k, v in load_torch_state_dict(path).items()}
    if getattr(cfg.MODEL, "ARCH", "DeMo") == "DeMo_Parallel":
        params, stats = convert_demo_parallel(sd, cfg)
    else:
        params, stats = convert_demo(sd, cfg)
    return graft(model, params, stats)
