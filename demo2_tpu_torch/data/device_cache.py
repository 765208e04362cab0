"""Device-resident uint8 dataset cache and on-device augmentation
(demo2_tpu/data/device_cache.py).

The dataset lives on the card as one (N, 3, H, W, 3) uint8 tensor (RGBNT201's
train split at 256x128 is about 400 MB); a train step gathers its batch by
index and augments it on the card, so the host sends nothing but indices.

Augmentation (the host pipeline's order: flip -> /255 -> pad(10, zeros) ->
random crop -> normalize -> random erasing with N(0, 1) noise) draws one set
of parameters per (sample, modality).  flip, pad and crop are index
permutations, folded into two gathers on the uint8 data, as the JAX package
folds them.  The draws come from a torch.Generator: the same distributions
as JAX's, not the same numbers; `apply_augment` takes the parameters and the
noise as tensors, so a test can feed it JAX's.

`build_device_cache` fills it from a data pipe (data/loader.py): every image
decoded and resized once, through the native loader or PIL, the decoded
array kept on the host's disk keyed by the files' identity, so the next run
skips the decode; `DeviceCache.from_arrays` takes uint8 arrays in memory.
"""

from __future__ import annotations

import hashlib
import math
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.collectives import batch_rand, batch_randint, batch_randn


def draw_aug_params(generator: torch.Generator, batch: int, size: Tuple[int, int], *,
                    device: torch.device, flip_prob: float = 0.5, padding: int = 10,
                    re_prob: float = 0.5, min_area: float = 0.02, max_area: float = 1.0 / 3.0,
                    min_aspect: float = 0.3, attempts: int = 10) -> Dict[str, torch.Tensor]:
    """Per-(sample, modality) parameters, each (B, 3): random erasing tries
    `attempts` (area, aspect) proposals and takes the first that fits; none
    fits -> no erase, as the host loop falls through.  Under data parallelism
    (parallel/collectives.py) `batch` is this rank's rows, each drawn as the
    one-process step draws it."""
    h, w = size
    shape = (batch, 3)
    u = lambda *sh: batch_rand(sh, generator=generator, device=device)
    flip = u(*shape) < flip_prob
    crop_top = batch_randint(0, 2 * padding + 1, shape, generator=generator, device=device)
    crop_left = batch_randint(0, 2 * padding + 1, shape, generator=generator, device=device)
    tgt = (min_area + (max_area - min_area) * u(*shape, attempts)) * float(h * w)
    lo, hi = math.log(min_aspect), math.log(1.0 / min_aspect)
    asp = torch.exp(lo + (hi - lo) * u(*shape, attempts))
    eh = torch.round(torch.sqrt(tgt * asp)).long()
    ew = torch.round(torch.sqrt(tgt / asp)).long()
    valid = (eh < h) & (ew < w)
    first = valid.int().argmax(-1, keepdim=True)  # the first valid attempt
    eh, ew = eh.gather(-1, first)[..., 0], ew.gather(-1, first)[..., 0]
    # top ~ U{0 .. h - eh}: floor(u * (h - eh + 1)).
    etop = torch.floor(u(*shape) * (h - eh + 1).float()).long()
    eleft = torch.floor(u(*shape) * (w - ew + 1).float()).long()
    erase = (u(*shape) <= re_prob) & valid.any(-1)
    return {"flip": flip, "crop_top": crop_top, "crop_left": crop_left, "erase": erase,
            "erase_top": etop, "erase_left": eleft, "erase_h": eh, "erase_w": ew}


def apply_augment(u8: torch.Tensor, params: Dict[str, torch.Tensor], mean: Sequence[float],
                  std: Sequence[float], noise: torch.Tensor, padding: int = 10,
                  idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 (B, 3, H, W, 3) -> augmented f32, or with `idx` the batch of
    the whole cache `u8` (N, 3, H, W, 3) at those samples.  `noise` is the
    (B, 3, H, W, 3) N(0, 1) fill of the erased rectangles."""
    dev = u8.device
    _, m, h, w, _ = u8.shape
    if idx is not None:
        n = u8.shape[0]
        lin = idx.long()[:, None] * m + torch.arange(m, device=dev)  # (B, 3) planes
        u8 = u8.reshape(n * m, h, w, -1)[lin.reshape(-1).clamp(0, n * m - 1)]
        u8 = u8.reshape(idx.shape[0], m, h, w, -1)
    b = u8.shape[0]
    p = padding
    # The crop window [top, top + h) x [left, left + w) of the padded image
    # reads source (top - p + i, left - p + j); out of range = the pad zeros.
    rows = params["crop_top"][..., None] - p + torch.arange(h, device=dev)  # (B, 3, h)
    cols = params["crop_left"][..., None] - p + torch.arange(w, device=dev)  # (B, 3, w)
    in_h = (rows >= 0) & (rows < h)
    in_w = (cols >= 0) & (cols < w)
    src_cols = torch.where(params["flip"][..., None], w - 1 - cols, cols).clamp(0, w - 1)
    src_rows = rows.clamp(0, h - 1)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    mi = torch.arange(m, device=dev)[None, :, None, None]
    x = u8[bi, mi, src_rows[..., None], src_cols[:, :, None, :]]  # (B, 3, h, w, 3)
    x = x.float() / 255.0
    pad_mask = in_h[..., :, None] & in_w[..., None, :]
    x = torch.where(pad_mask[..., None], x, torch.zeros((), device=dev))
    x = (x - torch.tensor(mean, dtype=torch.float32, device=dev)) / torch.tensor(
        std, dtype=torch.float32, device=dev)
    yy = torch.arange(h, device=dev)[None, None, :, None]
    xx = torch.arange(w, device=dev)[None, None, None, :]
    top = params["erase_top"][..., None, None]
    left = params["erase_left"][..., None, None]
    rect = ((yy >= top) & (yy < top + params["erase_h"][..., None, None])
            & (xx >= left) & (xx < left + params["erase_w"][..., None, None])
            & params["erase"][..., None, None])
    return torch.where(rect[..., None], noise, x)


def augment_batch(u8: torch.Tensor, generator: torch.Generator, size: Tuple[int, int],
                  mean: Sequence[float], std: Sequence[float], flip_prob: float = 0.5,
                  padding: int = 10, re_prob: float = 0.5,
                  idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    batch = u8.shape[0] if idx is None else idx.shape[0]
    params = draw_aug_params(generator, batch, size, device=u8.device, flip_prob=flip_prob,
                             padding=padding, re_prob=re_prob)
    noise = batch_randn((batch, 3, *size, 3), generator=generator, device=u8.device)
    return apply_augment(u8, params, mean, std, noise, padding=padding, idx=idx)


def normalize_batch(u8: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Eval path: /255 + normalize only."""
    dev = u8.device
    return (u8.float() / 255.0 - torch.tensor(mean, dtype=torch.float32, device=dev)) / \
        torch.tensor(std, dtype=torch.float32, device=dev)


@dataclass
class DeviceCache:
    """A decoded dataset resident on the device."""

    images: torch.Tensor  # (N, 3, H, W, 3) uint8
    pids: torch.Tensor    # (N,) int64
    camids: torch.Tensor
    viewids: torch.Tensor
    size: Tuple[int, int]
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    train: bool  # True -> augment_batch; False -> normalize_batch
    flip_prob: float = 0.5
    padding: int = 10
    re_prob: float = 0.5
    decode_seconds: float = 0.0  # the one-time decode of build_device_cache

    @classmethod
    def from_arrays(cls, images: np.ndarray, samples, *, train: bool, cfg,
                    device: torch.device) -> "DeviceCache":
        """`images` (N, 3, H, W, 3) uint8 already at the transform's size;
        `samples` the matching (ref, pid, camid, trackid) tuples; the
        transform's parameters from cfg.INPUT, as make_dataloader builds
        them."""
        size = tuple(cfg.INPUT.SIZE_TRAIN if train else cfg.INPUT.SIZE_TEST)
        if images.dtype != np.uint8 or images.shape[1:] != (3, *size, 3):
            raise ValueError(f"images must be uint8 (N, 3, {size[0]}, {size[1]}, 3), got "
                             f"{images.dtype} {images.shape}")
        col = lambda i: torch.tensor([s[i] for s in samples], dtype=torch.int64, device=device)
        return cls(
            images=torch.from_numpy(np.ascontiguousarray(images)).to(device),
            pids=col(1), camids=col(2), viewids=col(3), size=size,
            mean=tuple(float(v) for v in cfg.INPUT.PIXEL_MEAN),
            std=tuple(float(v) for v in cfg.INPUT.PIXEL_STD), train=train,
            flip_prob=cfg.INPUT.PROB, padding=cfg.INPUT.PADDING, re_prob=cfg.INPUT.RE_PROB,
        )

    def batch(self, idx: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(images f32 (B, 3, H, W, 3), pids, camids) at `idx`: augmented
        with draws from `generator` for a train cache, normalised for eval."""
        idx = idx.to(self.images.device)
        if self.train:
            images = augment_batch(self.images, generator, self.size, self.mean, self.std,
                                   self.flip_prob, self.padding, self.re_prob, idx=idx)
        else:
            images = normalize_batch(self.images[idx], self.mean, self.std)
        return images, self.pids[idx], self.camids[idx]


# ---------------------------------------------------------------------------
# Decode once, from a data pipe
# ---------------------------------------------------------------------------

# The decoded uint8 array is kept on the host's disk, keyed by the dataset's
# file identity, so decoding is paid once per machine, not once per run.
DECODE_CACHE_DIR = os.environ.get("DEMO2_DECODE_CACHE_DIR",
                                  os.path.join(tempfile.gettempdir(), "d2t_torch_decode_cache"))
# Size budget: a re-rendered dataset writes a fresh entry; the oldest entries
# go past this many bytes.
DECODE_CACHE_MAX_BYTES = int(os.environ.get("DEMO2_DECODE_CACHE_MAX_BYTES", 8 << 30))


def _prune_decode_cache(keep: str) -> None:
    """Evict the oldest .npy entries beyond DECODE_CACHE_MAX_BYTES (never
    `keep`, the entry just written)."""
    try:
        entries = []
        for name in os.listdir(DECODE_CACHE_DIR):
            if not name.endswith(".npy"):
                continue
            path = os.path.join(DECODE_CACHE_DIR, name)
            st = os.stat(path)
            entries.append((st.st_mtime, st.st_size, path))
        total = sum(size for _, size, _ in entries)
        for _, size, path in sorted(entries):  # oldest first
            if total <= DECODE_CACHE_MAX_BYTES:
                break
            if os.path.abspath(path) == os.path.abspath(keep):
                continue
            os.unlink(path)
            total -= size
    except OSError:
        pass  # best-effort housekeeping


def _decode_cache_key(pipe, train: bool) -> Optional[str]:
    """A key over every sample's (path, size, mtime), the resize geometry,
    the filter and the decoder; None for in-memory (synthetic) samples."""
    h, w = pipe.transform.size
    decoder = "pil"
    if pipe.use_native:
        from .native import native_library

        decoder = native_library().decoder
    hasher = hashlib.sha1(f"v1|{h}x{w}|train={train}|decoder={decoder}".encode())
    try:
        for ref, *_ in pipe.samples:
            for path in [ref] if isinstance(ref, str) else list(ref):
                if not isinstance(path, str):
                    return None
                st = os.stat(path)
                hasher.update(f"{path}|{st.st_size}|{st.st_mtime_ns}".encode())
    except (OSError, TypeError):
        return None
    return hasher.hexdigest()


def _decode_all_cached(pipe, train: bool) -> np.ndarray:
    """_decode_all, read back from DECODE_CACHE_DIR where this dataset was
    decoded before (memory-mapped)."""
    key = _decode_cache_key(pipe, train)
    if key is None:
        return _decode_all(pipe, train)
    path = os.path.join(DECODE_CACHE_DIR, f"{key}.npy")
    if os.path.exists(path):
        try:
            return np.load(path, mmap_mode="r")
        except (OSError, ValueError):
            pass  # a torn write of a crashed run: decode again
    out = _decode_all(pipe, train)
    try:
        os.makedirs(DECODE_CACHE_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:  # np.save(path) would append .npy
            np.save(f, out)
        os.replace(tmp, path)
        _prune_decode_cache(keep=path)
    except OSError:
        pass  # keeping it is best-effort; the decode stands
    return out


def _decode_all(pipe, train: bool) -> np.ndarray:
    """Every sample decoded and resized once -> (N, 3, H, W, 3) uint8:
    bicubic for a train cache (TrainTransform's filter), bilinear for eval
    (EvalTransform's)."""
    h, w = pipe.transform.size
    n = len(pipe.samples)
    out = np.empty((n, 3, h, w, 3), np.uint8)
    if pipe.use_native:
        # Identity params, mean 0 / std 1 -> [0, 1] floats -> uint8.
        from .loader import STRIPS
        from .native import INTERP_BILINEAR, INTERP_CUBIC, eval_params, load_batch_native

        interp = INTERP_CUBIC if train else INTERP_BILINEAR
        chunk = 256
        for start in range(0, n, chunk):
            stop = min(n, start + chunk)
            paths, params = [], []
            for i in range(start, stop):
                ref = pipe.samples[i][0]
                for path, strip in ([(ref, s) for s in STRIPS] if isinstance(ref, str)
                                    else [(p, None) for p in ref]):
                    paths.append(path)
                    params.append(eval_params(strip, interp))
            flat = load_batch_native(paths, params, h, w, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                     num_threads=pipe.num_workers)
            out[start:stop] = np.clip(np.round(flat.reshape(-1, 3, h, w, 3) * 255.0), 0,
                                      255).astype(np.uint8)
        return out

    from PIL import Image

    from .loader import read_image

    interp = Image.BICUBIC if train else Image.BILINEAR

    def one(i):
        imgs = read_image(pipe.samples[i][0], pipe.dataset)
        return np.stack([np.asarray(im.resize((w, h), interp), np.uint8) for im in imgs])

    for i, arr in enumerate(pipe.pool.map(one, range(n))):
        out[i] = arr
    return out


def build_device_cache(pipe, device: torch.device, train: Optional[bool] = None) -> DeviceCache:
    """Decode the pipe's dataset once and park it on `device`; `train`
    defaults to whether the pipe's transform is TrainTransform."""
    from .transforms import TrainTransform

    if train is None:
        train = isinstance(pipe.transform, TrainTransform)
    t0 = time.perf_counter()
    images = _decode_all_cached(pipe, train)
    decode_s = time.perf_counter() - t0
    if not images.flags.writeable:  # the read-only memory map of a kept decode
        images = np.array(images)
    tf = pipe.transform
    col = lambda i: torch.tensor([s[i] for s in pipe.samples], dtype=torch.int64, device=device)
    return DeviceCache(
        images=torch.from_numpy(np.ascontiguousarray(images)).to(device),
        pids=col(1), camids=col(2), viewids=col(3), size=(tf.size[0], tf.size[1]),
        mean=tuple(float(v) for v in np.asarray(tf.mean).ravel()),
        std=tuple(float(v) for v in np.asarray(tf.std).ravel()), train=train,
        flip_prob=getattr(tf, "flip_prob", 0.5), padding=getattr(tf, "padding", 10),
        re_prob=getattr(tf, "re_prob", 0.5), decode_seconds=decode_s,
    )
