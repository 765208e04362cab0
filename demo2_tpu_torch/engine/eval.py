"""Eval forward and the missing-modality masks (demo2_tpu/engine/eval.py).

run_eval / do_inference, which drive a dataset, come with the port's
entry points (ROADMAP.md, port queue).
"""

from __future__ import annotations

import torch

MISS_MASKS = {
    "None": (1.0, 1.0, 1.0),
    "nothing": (1.0, 1.0, 1.0),  # alias used by reference YAMLs
    "r": (0.0, 1.0, 1.0),
    "n": (1.0, 0.0, 1.0),
    "t": (1.0, 1.0, 0.0),
    "rn": (0.0, 0.0, 1.0),
    "rt": (0.0, 1.0, 0.0),
    "nt": (1.0, 0.0, 0.0),
}


def miss_mask(miss: str, *, device: torch.device) -> torch.Tensor:
    """The (3,) modality mask of a TEST.MISS value."""
    if miss not in MISS_MASKS:
        raise ValueError(f"TEST.MISS={miss!r} is not a valid missing-modality pattern; "
                         f"expected one of {sorted(MISS_MASKS)}")
    return torch.tensor(MISS_MASKS[miss], dtype=torch.float32, device=device)


@torch.inference_mode()
def eval_step(model, images: torch.Tensor, camids: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """The eval forward: the f32 embedding of a batch."""
    return model(images, camids, mask, train=False)["embedding"]
