"""Host image transforms (demo2_tpu/data/transforms.py), PIL + numpy.

Train: resize (bicubic) -> horizontal flip (0.5) -> /255 -> pad (10, zeros)
-> random crop -> normalize -> pixel-mode random erasing (timm's, p = 0.5);
eval: resize (bilinear, torchvision Resize's default) -> /255 -> normalize.
Each modality is transformed on its own, its draws from a numpy Generator.
PIL is imported inside __call__ only: a machine without PIL imports this
module and takes the native loader (data/native.py) instead.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


class TrainTransform:
    def __init__(
        self,
        size: Tuple[int, int] = (256, 128),
        flip_prob: float = 0.5,
        padding: int = 10,
        re_prob: float = 0.5,
        mean: Sequence[float] = (0.5, 0.5, 0.5),
        std: Sequence[float] = (0.5, 0.5, 0.5),
    ):
        self.size = tuple(size)
        self.flip_prob = flip_prob
        self.padding = padding
        self.re_prob = re_prob
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, rng: np.random.Generator) -> np.ndarray:
        from PIL import Image

        h, w = self.size
        img = img.resize((w, h), Image.BICUBIC)
        if rng.random() < self.flip_prob:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        arr = np.asarray(img, np.float32) / 255.0  # (H, W, 3)
        p = self.padding
        arr = np.pad(arr, ((p, p), (p, p), (0, 0)))
        top = int(rng.integers(0, 2 * p + 1))
        left = int(rng.integers(0, 2 * p + 1))
        arr = arr[top : top + h, left : left + w]
        arr = (arr - self.mean) / self.std
        return random_erasing(arr, rng, probability=self.re_prob)


class EvalTransform:
    def __init__(
        self,
        size: Tuple[int, int] = (256, 128),
        mean: Sequence[float] = (0.5, 0.5, 0.5),
        std: Sequence[float] = (0.5, 0.5, 0.5),
    ):
        self.size = tuple(size)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, rng=None) -> np.ndarray:
        from PIL import Image

        h, w = self.size
        img = img.resize((w, h), Image.BILINEAR)  # torchvision Resize's default
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - self.mean) / self.std


def random_erasing(
    arr: np.ndarray,
    rng: np.random.Generator,
    probability: float = 0.5,
    min_area: float = 0.02,
    max_area: float = 1.0 / 3.0,
    min_aspect: float = 0.3,
    max_attempts: int = 10,
) -> np.ndarray:
    """timm-style pixel-mode random erasing (reference: make_dataloader.py:48-139),
    in place: the first of `max_attempts` (area, aspect) proposals that fits
    is filled with N(0, 1) noise."""
    if rng.random() > probability:
        return arr
    h, w, c = arr.shape
    area = h * w
    log_ratio = (math.log(min_aspect), math.log(1.0 / min_aspect))
    for _ in range(max_attempts):
        target = rng.uniform(min_area, max_area) * area
        aspect = math.exp(rng.uniform(*log_ratio))
        eh = int(round(math.sqrt(target * aspect)))
        ew = int(round(math.sqrt(target / aspect)))
        if eh < h and ew < w:
            top = int(rng.integers(0, h - eh + 1))
            left = int(rng.integers(0, w - ew + 1))
            arr[top : top + eh, left : left + ew] = rng.normal(size=(eh, ew, c)).astype(np.float32)
            break
    return arr
