"""Training diagnostics of the port (demo2_tpu's tools/diagnose_training.py;
reference: diagnose_training.py).

    python3 -m demo2_tpu_torch.tools.diagnose_training [--config_file CFG] [KEY VALUE ...]

On one tiny random batch of 8 (4 ids x 2): 1. the output format, every
branch's (logits, feat) shapes with its loss weight, the auxiliary losses,
the embedding; 2. the gradient flow, the largest |grad| of each top-level
module and the parameters left without a gradient; 3. value ranges, the
embedding and the total loss finite.  Without a config file it builds the
flagship's modules (SDTPS + DGAF v3 on ViT-B-16); `--tiny` (on by default)
shrinks the backbone to 2 blocks of width 64 at 32x16 in f32 without the
block kernels.  It runs on cuda:0 unless MODEL.DEVICE is "cpu" (JAX's
`--tpu` is accepted: the card is already the default).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """Print the diagnosis; returns {"dead": [names], "total": n, "loss": x}."""
    from ..losses.losses import branch_weights, make_loss_fn
    from ..models import make_model
    from .train import entry_device, load_config

    p = argparse.ArgumentParser()
    p.add_argument("--config_file", default="", type=str)
    p.add_argument("--tiny", action="store_true", default=True)
    p.add_argument("--tpu", action="store_true",
                   help="run on the accelerator (the port's default: cuda:0)")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    cfg = load_config(args.config_file, [])
    if not args.config_file:
        cfg.MODEL.TRANSFORMER_TYPE = "ViT-B-16"
        cfg.MODEL.USE_SDTPS = True
        cfg.MODEL.USE_DGAF = True
    cfg.merge_from_list(list(args.opts))
    if args.tiny:
        cfg.INPUT.SIZE_TRAIN = (32, 16)
        cfg.TPU.BACKBONE_DEPTH = 2
        cfg.TPU.BACKBONE_WIDTH = 64
        cfg.TPU.BACKBONE_HEADS = 2
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.TPU.USE_FLASH_ATTENTION = False
    cfg.freeze()
    device = entry_device(cfg, device)

    num_classes, cams, b = 8, 4, 8
    model = make_model(cfg, num_classes, cams, device=device,
                       generator=torch.Generator().manual_seed(0))
    h, w = cfg.INPUT.SIZE_TRAIN
    gen = torch.Generator().manual_seed(0)
    images = (torch.randn(b, 3, h, w, 3, generator=gen) * 0.5).to(device)
    pids = torch.from_numpy(np.repeat(np.arange(4), 2)).to(device)
    camids = torch.zeros(b, dtype=torch.long, device=device)

    def forward():
        return model(images, camids, train=True,
                     generator=torch.Generator(device=device).manual_seed(0))

    print("=" * 60)
    print("1. OUTPUT FORMAT")
    with torch.no_grad():
        out = forward()
    weights = branch_weights(cfg, out["branches"].keys())
    for name, (logits, feat) in out["branches"].items():
        print(f"  branch {name:12s} logits{tuple(logits.shape)} feat{tuple(feat.shape)} "
              f"weight={weights[name]}")
    for name, v in out["aux_loss"].items():
        print(f"  aux    {name:12s} value={float(v):.4f}")
    print(f"  embedding {tuple(out['embedding'].shape)}")

    print("=" * 60)
    print("2. GRADIENT FLOW")
    loss_fn = make_loss_fn(cfg, num_classes)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def total_loss():
        o = forward()
        t = sum(weights[nm] * loss_fn(lg, ft, pids) for nm, (lg, ft) in o["branches"].items())
        return t + sum(o["aux_loss"].values())

    model.load_state_dict(init)  # the same BatchNorm statistics as the first forward
    loss = total_loss()
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    dead, groups = [], {}
    for (name, _), g in zip(named, grads):
        gmax = 0.0 if g is None else float(g.abs().max())
        top = name.split(".")[0]
        groups[top] = max(groups.get(top, 0.0), gmax)
        if gmax == 0.0:
            dead.append(name)
    for top, gmax in sorted(groups.items()):
        status = "OK " if gmax > 0 else "DEAD"
        print(f"  [{status}] {top:24s} max|grad| = {gmax:.3e}")
    print(f"  {len(named) - len(dead)}/{len(named)} parameters receive gradient")
    if dead:
        print("  zero-gradient params (expected for e.g. unused branches):")
        for d in dead[:10]:
            print(f"    - {d}")

    print("=" * 60)
    print("3. VALUE RANGES")
    emb = out["embedding"]
    print(f"  embedding: finite={bool(torch.isfinite(emb).all())} "
          f"mean={float(emb.mean()):.4f} std={float(emb.std(correction=0)):.4f}")
    model.load_state_dict(init)
    with torch.no_grad():
        loss_val = total_loss()
    print(f"  total loss: {float(loss_val):.4f} finite={bool(torch.isfinite(loss_val))}")
    print("=" * 60)
    print("DIAGNOSIS COMPLETE")
    return {"dead": dead, "total": len(named), "loss": float(loss_val)}


if __name__ == "__main__":
    main()
