"""demo2_tpu_torch: the PyTorch / CUDA port of demo2_tpu.

The package mirrors demo2_tpu's module paths.  Two slices of the flagship
model, DeMo (SDTPS + DGAF v3 on CLIP ViT-B/16), are ported: serving (the
eval forward, the embedding extractor and the retrieval metrics) and
training (losses, optimizer, device-resident data cache with on-device
augmentation, train step, epoch loop with eval and checkpoints).  The Pallas
kernels of those paths (the ViT's fused attention and MLP sub-blocks, the
training forward with its residuals and the saved-probs attention backward)
are hand-written CUDA kernels for Hopper (sm_90a) under csrc/, built at
first use (ops/kernel_lib.py).  The package imports torch and never jax.
"""

__version__ = "0.1.0"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a configuration outside the ported slices; `item` names
    the entry of ROADMAP.md's port queue that will port it."""
    return NotImplementedError(
        f"{what} is not ported to demo2_tpu_torch yet (ROADMAP.md, port queue: {item})"
    )
