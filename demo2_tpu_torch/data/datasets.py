"""The procedural tri-modal dataset (demo2_tpu/data/datasets.py::
SyntheticTriModal): identities with their own colour palettes and stripe
widths, rendered from a seed to the same uint8 images as the JAX package.
The on-disk parsers (RGBNT201, RGBNT100, MSVR310) are not ported yet: they
decode JPEGs through PIL (ROADMAP.md, port queue: eval entry points and
datasets)."""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np


class SyntheticTriModal:
    """Samples are (ref, pid, camid, trackid); `render(ref)` gives the three
    (H, W, 3) uint8 modality images of a sample."""

    def __init__(self, num_pids: int = 8, num_cams: int = 4, imgs_per_pid: int = 8,
                 image_size: Tuple[int, int] = (64, 32), seed: int = 0, hard: bool = False,
                 id_weight: float = 0.35):
        self.image_size = image_size
        self.hard = hard
        self.id_weight = float(id_weight)
        rng = np.random.default_rng(seed)
        self._palettes = rng.uniform(0.1, 0.9, size=(num_pids, 3, 3))  # pid, modality, rgb
        if hard:
            base = rng.uniform(0.3, 0.7, size=(1, 3, 3))
            self._palettes = 0.55 * base + 0.45 * self._palettes

        def split(tag):
            return [((tag, pid, j), pid, (pid + j) % num_cams, j % 3)
                    for pid in range(num_pids) for j in range(imgs_per_pid)]

        self.train = split("train")
        self.query = split("test")[: num_pids * 2]
        self.gallery = split("gallery")
        self.num_train_pids = len({s[1] for s in self.train})
        self.num_train_cams = len({s[2] for s in self.train})

    def render(self, ref) -> List[np.ndarray]:
        tag, pid, j = ref
        h, w = self.image_size
        # Stable across processes (builtin str hash is PYTHONHASHSEED-random).
        rng = np.random.default_rng(zlib.crc32(f"{tag}/{pid}/{j}".encode()))
        yy, _ = np.mgrid[0:h, 0:w]
        imgs = []
        for m in range(3):
            base = np.ones((h, w, 3), np.float32) * self._palettes[pid, m]
            if self.hard:
                stripe = ((yy // 4) % 2).astype(np.float32)[..., None]
                jitter = rng.uniform(-0.18, 0.18)
                img = (self.id_weight * base + 0.15 * stripe
                       + 0.5 * rng.uniform(0, 1, (h, w, 3)) + jitter)
            else:
                stripe = ((yy // max(2, pid + 2)) % 2).astype(np.float32)[..., None]
                img = 0.7 * base + 0.2 * stripe + 0.1 * rng.uniform(0, 1, (h, w, 3))
            imgs.append((img * 255).clip(0, 255).astype(np.uint8))
        return imgs

    def render_all(self, samples) -> np.ndarray:
        """(N, 3, H, W, 3) uint8 of `samples`, in order."""
        return np.stack([np.stack(self.render(s[0])) for s in samples])
