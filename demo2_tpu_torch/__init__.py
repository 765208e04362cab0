"""demo2_tpu_torch: the PyTorch / CUDA port of demo2_tpu.

The package mirrors demo2_tpu's module paths.  Of DeMo, on CLIP ViT-B/16,
the ImageNet ViT family, T2T-ViT, ResNet / IBN or OSNet / AIN, in its branches (the flagship SDTPS + DGAF v3, the
Baseline, SDTPS or DGAF alone, DGAF v1, and DeMo's own HDM + ATMoE fusion;
config/yaml_loader.py loads the configs/ files that select them), these
paths are ported: serving (the eval forward, the embedding extractor, the retrieval
metrics), training (losses, optimizer, device-resident data cache with
on-device augmentation, train step, epoch loop with eval and checkpoints,
optionally with the one-pass LayerNorm backward, TPU.PALLAS_LN_BWD, with the
backbone's blocks recomputed in the backward, TPU.REMAT_BACKBONE, with center
loss and with the timm cosine schedule; the metric-learning losses), and
evaluation with k-reciprocal re-ranking (TEST.RE_RANKING) under the camera
protocol or MSVR310's scene protocol with its rank list file.  The input
path from disk (the dataset parsers, the PIL transforms, a native JPEG loader
built from native/ at first use, host batches or the decoded device
cache) and the CLIs (`python -m demo2_tpu_torch.tools.train` / `.test`,
with the metrics log and MODEL.PRETRAIN_PATH_T) drive them; the quality gate
(`python -m demo2_tpu_torch.tools.quality_gate`) checks what training learns.  The CLIP
tower trains in its tuning paths too (MODEL.FROZEN with LoRA, MODEL.ADAPTER,
MODEL.PROMPT), a reference-trained checkpoint loads through
utils/ref_convert.py (tools/train.py --init_pth, a .pth TEST.WEIGHT), and
models/clip_text.py is the CLIP text tower with its BPE tokenizer.  The CLIP
MLP runs an int8 forward under TPU.INT8_MLP (ops/quant.py, torch._int_mm),
and the analysis stack (utils/profiling.py, visualize/ with Grad-CAM through
DeMo's patch probe, and the gradcam / miss_sweep / compare_modules /
diagnose_training / run_experiments CLIs) is ported too.  The Pallas
kernels of those paths (the ViT's fused attention and MLP sub-blocks, the
training forward with its residuals, the attention backwards, the packed and
head-major attention, the LayerNorm backward, the re-ranking min-sum) are
hand-written CUDA kernels for Hopper (sm_90a) under csrc/, built at first
use (ops/kernel_lib.py); the packed attention has a second pair for heads of
96 and up to 256 tokens.  The CNN trunks run no hand-written kernel (cuDNN
convolutions, as the JAX package leaves them to XLA).  The package imports torch and never jax.
"""

__version__ = "0.1.0"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a configuration outside the ported slices; `item` names
    the entry of ROADMAP.md's port queue that will port it."""
    return NotImplementedError(
        f"{what} is not ported to demo2_tpu_torch yet (ROADMAP.md, port queue: {item})"
    )
