"""Serving: the embedding extractor and the retrieval op (demo2_tpu/serving.py).

`FeatureExtractor` keeps the JAX package's contract: ragged requests are
padded to the fixed batch size by repeating the last row, an empty request
returns a (0, D) array without touching the device, the embeddings come back
as numpy, L2-normalised (norm clamped at 1e-12) unless the extractor was
made with normalize=False, and the missing-modality mask is a runtime input
of the one forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config.defaults import Config
from .engine.eval import eval_step, miss_mask
from .utils.metrics import euclidean_distance


class FeatureExtractor:
    def __init__(self, cfg: Config, model, *, device: torch.device, batch_size: int = 64,
                 normalize: bool = True):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.normalize = normalize

    def _embed(self, images: np.ndarray, cams: np.ndarray, mask: torch.Tensor,
               views: Optional[np.ndarray]) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32)).to(self.device)
        ids = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(self.device)
        out = eval_step(self.model, x, ids(cams), mask, None if views is None else ids(views))
        if self.normalize:
            out = out / out.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return out.cpu().numpy()

    def extract(self, images: np.ndarray, camids: Optional[np.ndarray] = None,
                miss: str = "None", viewids: Optional[np.ndarray] = None) -> np.ndarray:
        """Embed (N, 3, H, W, 3) float32 images, already transform-normalised
        ((x/255 - PIXEL_MEAN) / PIXEL_STD); any N, including 0.  `viewids`
        feed the ImageNet ViT's view SIE (MODEL.SIE_VIEW); the JAX
        extractor passes none."""
        n = images.shape[0]
        if n == 0:
            return np.zeros((0, self.model.embed_dim), np.float32)
        mask = miss_mask(miss, device=self.device)
        if camids is None:
            camids = np.zeros((n,), np.int64)
        bs = self.batch_size
        outs = []
        pad = lambda a, valid: np.concatenate([a, np.repeat(a[-1:], bs - valid, axis=0)])
        for i in range(0, n, bs):
            chunk, cams = images[i : i + bs], camids[i : i + bs]
            views = None if viewids is None else viewids[i : i + bs]
            valid = chunk.shape[0]
            if valid < bs:
                chunk, cams = pad(chunk, valid), pad(cams, valid)
                views = None if views is None else pad(views, valid)
            outs.append(self._embed(chunk, cams, mask, views)[:valid])
        return np.concatenate(outs, axis=0)


def match(query_emb: np.ndarray, gallery_emb: np.ndarray, topk: int = 10, *,
          device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """Rank the gallery for each query on `device`: (indices, distances), top-k."""
    d = euclidean_distance(torch.from_numpy(np.asarray(query_emb)).to(device),
                           torch.from_numpy(np.asarray(gallery_emb)).to(device))
    idx = torch.argsort(d, dim=1, stable=True)[:, :topk]
    return idx.cpu().numpy(), d.gather(1, idx).cpu().numpy()
