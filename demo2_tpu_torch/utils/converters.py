"""Flax variables of demo2_tpu -> state_dict of the port.

The inverse of demo2_tpu/utils/converters.py's layout rules (`_t`, `_conv`):
  * a Dense kernel (in, out) becomes a Linear weight (out, in);
  * `in_proj_kernel` (C, 3C) becomes `in_proj_weight` (3C, C);
  * a conv kernel HWIO becomes OIHW (a depthwise (3, 3, 1, C) kernel the
    grouped (C, 1, 3, 3) weight), and a 1-D conv kernel (K, I, O), ECA's
    over the channel axis, the Conv1d weight (O, I, K) where the port has
    one;
  * LayerNorm / BatchNorm `scale` becomes `weight`; batch_stats `mean` /
    `var` become the `running_mean` / `running_var` buffers;
  * cv_embed, class_embedding, positional_embedding, proj, the DGAF queries
    and alpha, SDTPS's stacked (3, 3, C, C) or shared (3, 1, C, C) q/k
    kernels, GlobalLocalFuse's stacked (3, 2C, C) kernel and LayerNorm
    (`ln_scale`, `ln_bias`), HDM's stacked (7, ...) set tokens and
    projections, ATMoE's expert kernel and bias, SDTPSComplete's gate scales
    and biases and MultiModalSACRv2's modal_embed stay as they are.
Module names map one to one, with `resblocks_3` -> `resblocks.3`,
`blocks_3` -> `blocks.3` (the ImageNet ViT), `modal_weight_mlp_0` ->
`modal_weight_mlp.0`, and TorchLinear's inner `Dense_0` dropped; the
ImageNet ViT's `patch_embed_proj` conv (with bias), `cls_token`, `pos_embed`
and `sie_embed` keep their names.  The conversion is strict both ways: a
flax leaf that fills no port tensor, or a port tensor that no leaf fills,
raises.

`convert_train_state` carries a JAX train state into the port's TrainState:
the params and batch_stats (after any number of steps) into the model, and
optax's Adam state (count, and mu / nu, trees shaped like the params) into
the optimizer, under the same rules.

Pretrained backbones (MODEL.PRETRAIN_PATH_T), as
demo2_tpu/utils/converters.py converts them for the JAX package:
`load_torch_state_dict` reads a .pth / .pt file (a torch.jit archive such as
CLIP's, or a plain state dict read with weights_only=True);
`convert_clip_visual` and `convert_imagenet_vit` map a CLIP visual tower or
a timm / TransReID ViT onto the port's backbone names, the positional
embedding's square grid resized to the model's with torch's un-antialiased
bilinear interpolation; `merge_pretrained_backbone` copies them into a
model's backbone.  `load_imagenet_vit_pretrained` loads a ViT checkpoint
into an ImageNetViT, every block required.
"""

from __future__ import annotations

import logging
import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_LISTS = re.compile(r"^(resblocks|blocks|modal_weight_mlp)_(\d+)$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(value)


def _module_path(parts) -> list:
    out = []
    for p in parts:
        if p == "Dense_0":
            continue
        m = _LISTS.match(p)
        out.extend(m.groups() if m else (p,))
    return out


def _leaf(collection: str, name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if collection == "batch_stats":
        return {"mean": "running_mean", "var": "running_var"}[name], value
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        return name, value  # a stacked kernel (GlobalLocalFuse)
    if name == "in_proj_kernel" and value.ndim == 2:
        return "in_proj_weight", value.T
    if name == "scale":
        return "weight", value
    return name, value


def _convert(variables: Mapping, target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    unconsumed = []
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unexpected flax collection {collection!r}")
        for path, value in _flatten(tree):
            name, arr = _leaf(collection, path[-1], value)
            module = _module_path(path[:-1])
            key = ".".join(module + [name])
            conv1d = ".".join(module + ["weight"])
            if name == "kernel" and arr.ndim == 3 and key not in target and conv1d in target:
                key, arr = conv1d, arr.transpose(2, 1, 0)
            if key not in target or key in out:
                unconsumed.append("/".join((collection,) + path))
                continue
            if tuple(target[key].shape) != arr.shape:
                raise ValueError(f"{'/'.join((collection,) + path)} -> {key}: shape "
                                 f"{arr.shape} != port {tuple(target[key].shape)}")
            ref = target[key]
            arr = np.ascontiguousarray(arr, np.float32).reshape(arr.shape)  # keeps 0-d leaves 0-d
            out[key] = torch.from_numpy(arr).to(ref.device, ref.dtype)
    missing = sorted(set(target) - set(out))
    if unconsumed or missing:
        raise ValueError(f"flax leaves with no port tensor: {unconsumed}; "
                         f"port tensors no leaf filled: {missing}")
    return out


def convert_flax_variables(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """`variables` is the flax {"params", "batch_stats"} tree of `model`'s JAX
    counterpart, as nested dicts of arrays; returns a full state_dict for
    `model.load_state_dict`, on the model's devices and dtypes."""
    return _convert(variables, model.state_dict())


def _adam_state(opt_state):
    """The ScaleByAdamState inside an optax chain's state, or None."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if hasattr(opt_state, "inner_state"):
        return _adam_state(opt_state.inner_state)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def convert_train_state(variables: Mapping, opt_state, state, centers=None) -> None:
    """Load a JAX train state's variables and Adam state, and its center
    loss's centers where the port's TrainState `state` (engine/state.py) has
    centers, into `state`, in place."""
    if (centers is None) != (state.centers is None):
        raise ValueError("centers are given for a train state without center loss, or "
                         "missing for one with it")
    if centers is not None:
        state.centers.copy_(torch.from_numpy(np.array(centers, np.float32)))
    state.model.load_state_dict(convert_flax_variables(variables, state.model), strict=True)
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("the optax state holds no Adam state (count, mu, nu)")
    opt = state.optimizer
    moments = {}
    for slot in ("mu", "nu"):
        target = {n: st[slot] for n, st in opt.state.items()}
        moments[slot] = _convert({"params": getattr(adam, slot)}, target)
    opt.load_state_dict({"count": int(np.asarray(adam.count)),
                         "state": {n: {slot: moments[slot][n] for slot in moments}
                                   for n in opt.state}})


def resize_pos_embed_grid(pos: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """A (1 + N, C) positional embedding whose N tokens form a square grid,
    its grid resized to (new_h, new_w) with F.interpolate(mode='bilinear',
    align_corners=False), no antialiasing: what both reference loaders call
    and demo2_tpu/utils/converters.py::resize_pos_embed_grid mirrors."""
    tok, grid = pos[:1], pos[1:]
    if grid.shape[0] == new_h * new_w:
        return pos
    side = int(round(grid.shape[0] ** 0.5))
    grid = grid.reshape(1, side, side, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(new_h, new_w), mode="bilinear", align_corners=False)
    return torch.cat([tok, grid.permute(0, 2, 3, 1).reshape(new_h * new_w, -1)], dim=0)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The f32 tensors of a .pth / .pt file: a torch.jit archive (CLIP's
    released weights), or a state dict, bare or under "model" /
    "state_dict", read with weights_only=True."""
    try:
        sd = torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:  # not a TorchScript archive
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("model", "state_dict"):
            if isinstance(sd, dict) and key in sd:
                sd = sd[key]
    return {k: v.float() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _tensors(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in state_dict.items()}


_CLIP_BLOCK_KEYS = ("attn.in_proj_weight", "attn.in_proj_bias", "attn.out_proj.weight",
                    "attn.out_proj.bias", "ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
                    "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight", "mlp.c_proj.bias")


def convert_clip_visual(state_dict: Mapping, new_h: int, new_w: int) -> Dict[str, torch.Tensor]:
    """A CLIP visual tower's state dict (keys with or without "visual.")
    under the port's CLIPVisionTransformer names, the positional embedding
    resized to the (new_h, new_w) grid."""
    sd = _tensors(state_dict)
    pfx = "visual." if any(k.startswith("visual.") for k in sd) else ""
    out = {k: sd[pfx + k] for k in ("conv1.weight", "class_embedding", "ln_pre.weight",
                                    "ln_pre.bias", "ln_post.weight", "ln_post.bias", "proj")}
    out["positional_embedding"] = resize_pos_embed_grid(sd[pfx + "positional_embedding"],
                                                        new_h, new_w)
    i = 0
    while f"{pfx}transformer.resblocks.{i}.attn.in_proj_weight" in sd:
        out.update({f"resblocks.{i}.{k}": sd[f"{pfx}transformer.resblocks.{i}.{k}"]
                    for k in _CLIP_BLOCK_KEYS})
        i += 1
    return out


_VIT_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                   "attn.qkv.weight", "attn.proj.weight", "attn.proj.bias", "mlp.fc1.weight",
                   "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


def convert_imagenet_vit(state_dict: Mapping, new_h: int, new_w: int) -> Dict[str, torch.Tensor]:
    """A timm / TransReID ViT state dict under the port's ImageNetViT names:
    the patch conv, the final norm and the qkv bias where the checkpoint has
    them, cls_token, pos_embed (resized to the (new_h, new_w) grid) and every
    block; the rest (a classifier head) is not read."""
    sd = _tensors(state_dict)
    out = {"cls_token": sd["cls_token"],
           "pos_embed": resize_pos_embed_grid(sd["pos_embed"][0], new_h, new_w)[None]}
    for src, dst in (("patch_embed.proj", "patch_embed_proj"), ("norm", "norm")):
        if f"{src}.weight" in sd:
            out[f"{dst}.weight"], out[f"{dst}.bias"] = sd[f"{src}.weight"], sd[f"{src}.bias"]
    i = 0
    while f"blocks.{i}.attn.qkv.weight" in sd:
        keys = _VIT_BLOCK_KEYS + (("attn.qkv.bias",) if f"blocks.{i}.attn.qkv.bias" in sd else ())
        out.update({f"blocks.{i}.{k}": sd[f"blocks.{i}.{k}"] for k in keys})
        i += 1
    return out


def _copy_into(module: nn.Module, tensors: Mapping, strict: bool) -> list:
    """Copy `tensors` into `module`'s state in place: a shape mismatch
    raises; a tensor with no place raises if `strict`, else it is dropped
    with a warning.  Returns the names loaded."""
    target = module.state_dict()
    loaded, dropped = [], []
    for key, value in tensors.items():
        if key in target and tuple(target[key].shape) == tuple(value.shape):
            target[key].copy_(value)
            loaded.append(key)
        elif key in target or strict:
            raise ValueError(f"checkpoint {key} {tuple(value.shape)} has no place in the model "
                             f"({tuple(target[key].shape) if key in target else 'no such tensor'})")
        else:
            dropped.append(key)
    if dropped:
        # Name drift must be loud: a dropped tensor leaves its layer at random init.
        logging.getLogger("DeMo").warning(
            "merge_pretrained_backbone: %d converted tensors matched no model tensor and were "
            "dropped (first: %s)", len(dropped), ", ".join(dropped[:5]))
    return sorted(loaded)


def merge_pretrained_backbone(model: nn.Module, backbone: Mapping) -> list:
    """Copy converted backbone tensors (convert_clip_visual /
    convert_imagenet_vit) into `model.backbone.base`, in place, as the JAX
    package grafts them into params['backbone']['base']: a shape mismatch
    raises, a tensor with no place is dropped with a warning.  Returns the
    names loaded."""
    return _copy_into(model.backbone.base, backbone, strict=False)


def load_imagenet_vit_pretrained(model: nn.Module, state_dict: Mapping) -> list:
    """Load a timm / TransReID ViT state dict (torch layouts: tensors or
    arrays) into `model`, an ImageNetViT (models/vit.py), in place; every
    converted tensor must have its place.  The model's SIE embedding keeps
    its values.  Returns the names loaded."""
    return _copy_into(model, convert_imagenet_vit(state_dict, *model.grid), strict=True)


def load_pretrained_backbone(cfg, model: nn.Module, path: str) -> list:
    """MODEL.PRETRAIN_PATH_T: the CLIP visual tower (ViT-B-16) or an
    ImageNet ViT checkpoint at `path`, converted to the model's patch grid
    (models/pife.py::patch_grid_for) and merged into its backbone."""
    from ..models.pife import patch_grid_for

    sd = load_torch_state_dict(path)
    gh, gw = patch_grid_for(cfg.MODEL.TRANSFORMER_TYPE, tuple(cfg.INPUT.SIZE_TRAIN),
                            tuple(cfg.MODEL.STRIDE_SIZE))
    convert = convert_clip_visual if "ViT-B-16" in cfg.MODEL.TRANSFORMER_TYPE else \
        convert_imagenet_vit
    return merge_pretrained_backbone(model, convert(sd, gh, gw))
