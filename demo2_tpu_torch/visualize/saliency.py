"""Saliency maps of the tri-modal model (demo2_tpu/visualize/saliency.py;
reference: visualize/GradCAM.py).

  * `gradcam_heatmaps`: the gradient of the embeddings' L2 norm with respect
    to the input images, summed over colour, pooled to the patch grid, per
    modality;
  * `gradcam`: Grad-CAM over the backbone's patch tokens through the model's
    zero-valued `patch_perturb` probe (no hooks);
  * `save_gradcam_overlays`: the maps upsampled, jet-coloured and blended
    onto the images, one PNG per modality and sample;
  * `attention_rollout`: Abnar & Zuidema's rollout of per-layer attention maps.

Both map functions take the gradient with the model's parameters frozen for
the call, so no parameter gradient is computed: `gradcam_heatmaps` runs the
backbone's training forward for its input gradient (on the card kernels 3,
7 and 2's training form), `gradcam` the eval kernels 1 and 2, its probe
lying after the backbone.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import frozen_parameters

MODALITY_NAMES = ("RGB", "NI", "TI")


def _normalize_maps(maps: torch.Tensor) -> np.ndarray:
    """Min-max normalise each (gh, gw) map of (3, B, gh, gw) to [0, 1]."""
    lo = maps.amin(dim=(2, 3), keepdim=True)
    hi = maps.amax(dim=(2, 3), keepdim=True)
    return ((maps - lo) / (hi - lo + 1e-8)).cpu().numpy()


def gradcam_heatmaps(model, images: torch.Tensor, cam_label: Optional[torch.Tensor],
                     patch_grid: Tuple[int, int]) -> np.ndarray:
    """Per-modality saliency maps (3, B, gh, gw) in [0, 1]: |d(sum of the
    embeddings' norms) / d(images)| summed over colour, averaged over each
    patch cell of the cropped divisible region (overlapping-patch grids need
    not divide the image)."""
    gh, gw = patch_grid
    x = images.detach().float().requires_grad_(True)  # (B, 3, H, W, 3)
    with frozen_parameters(model):
        emb = model(x, cam_label, train=False)["embedding"]
        (g,) = torch.autograd.grad(emb.norm(dim=-1).sum(), x)
    sal = g.abs().sum(-1).transpose(0, 1)  # (3, B, H, W)
    m, b, h, w = sal.shape
    hh, ww = (h // gh) * gh, (w // gw) * gw
    sal = sal[:, :, :hh, :ww].reshape(m, b, gh, hh // gh, gw, ww // gw).mean(dim=(3, 5))
    return _normalize_maps(sal)


def gradcam(model, images: torch.Tensor, cam_label: Optional[torch.Tensor],
            view_label: Optional[torch.Tensor] = None, branch: Optional[str] = None,
            class_idx: Optional[torch.Tensor] = None) -> np.ndarray:
    """Grad-CAM over the backbone's patch tokens (3, B, gh, gw) in [0, 1]:
    A = the patch tokens (3, B, N, C), g = d(target) / dA through the
    zero-valued probe, the channel weights the token mean of g, cam =
    ReLU(sum_c w_c A_c), min-max normalised per map.  The target is each
    sample's `class_idx` logit of `branch`'s classifier (default the
    model's first branch), or, without `class_idx`, its argmax class in the
    same forward (pytorch_grad_cam's targets=None)."""
    gh, gw = model.grid
    b = images.shape[0]
    probe = torch.zeros(3, b, gh * gw, model.feat_dim, device=images.device,
                        requires_grad=True)
    with frozen_parameters(model):
        out = model(images, cam_label, view_label, None, train=False, patch_perturb=probe)
        logits = out["branches"][branch if branch is not None else next(iter(out["branches"]))][0]
        idx = logits.detach().argmax(-1) if class_idx is None else class_idx.to(logits.device)
        target = logits.gather(1, idx.long()[:, None]).sum()
        # A branch that never reads the patch tokens (the Baseline's) gives
        # zero gradients, as jax.grad does, and so all-zero maps.
        (grads,) = torch.autograd.grad(target, probe, allow_unused=True,
                                       materialize_grads=True)
    acts = out["patches"].detach().float()  # (3, B, N, C)
    weights = grads.mean(dim=2)  # (3, B, C): the gradients' mean over the tokens
    cam = torch.relu(torch.einsum("mbc,mbnc->mbn", weights, acts)).reshape(3, b, gh, gw)
    return _normalize_maps(cam)


def save_gradcam_overlays(cams: np.ndarray, images: np.ndarray, out_dir: str,
                          prefix: str = "cam") -> list:
    """cams (3, B, gh, gw), images (B, 3, H, W, 3) in any range: each map
    repeated up to the image size (ceil, then cropped), jet-coloured and
    blended half and half with the min-max normalised image, written as
    `<prefix>_<RGB|NI|TI>_<b>.png` under `out_dir`.  Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    m, b, gh, gw = cams.shape
    _, _, h, w, _ = images.shape
    paths = []
    for mi in range(m):
        for bi in range(b):
            ry, rx = -(-h // gh), -(-w // gw)
            cam_up = np.repeat(np.repeat(cams[mi, bi], ry, 0), rx, 1)[:h, :w]
            img = images[bi, mi].astype(np.float32)
            img = (img - img.min()) / (img.max() - img.min() + 1e-8)
            overlay = np.clip(0.5 * img + 0.5 * _jet(cam_up), 0.0, 1.0)
            path = os.path.join(out_dir, f"{prefix}_{MODALITY_NAMES[mi]}_{bi}.png")
            _write_png(path, (overlay * 255).astype(np.uint8))
            paths.append(path)
    return paths


def _jet(x: np.ndarray) -> np.ndarray:
    """Minimal jet colormap for (H, W) in [0, 1] -> (H, W, 3)."""
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def _write_png(path: str, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 PNG: PIL where it imports, else a zlib encoding."""
    try:
        from PIL import Image

        Image.fromarray(rgb).save(path)
    except ImportError:
        h, w, _ = rgb.shape
        raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

        def chunk(tag, data):
            c = tag + data
            return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n")
            f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
            f.write(chunk(b"IDAT", zlib.compress(raw)))
            f.write(chunk(b"IEND", b""))


def attention_rollout(attn_maps: np.ndarray) -> np.ndarray:
    """Rollout of per-layer attention maps (L, B, H, S, S) -> (B, S, S):
    heads averaged, the identity added, rows normalised, chained through
    the layers."""
    maps = attn_maps.mean(axis=2)  # (L, B, S, S)
    n_layers, b, s, _ = maps.shape
    eye = np.eye(s)[None]
    out = np.tile(eye, (b, 1, 1))
    for layer in range(n_layers):
        a = maps[layer] + eye
        a = a / a.sum(axis=-1, keepdims=True)
        out = a @ out
    return out
