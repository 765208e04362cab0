"""Optimizer and LR schedule (demo2_tpu/solver/optim.py's optax chains).

`Optimizer` applies make_optimizer's chain to a model's named f32
parameters, in place:
  * Adam / SGD: weight decay added to the gradient before the moments (L2,
    as torch.optim does it); AdamW: decoupled, added to the Adam update;
  * bias keys (a last name containing "bias") decay at WEIGHT_DECAY_BIAS;
  * LARGE_FC_LR doubles the update of every "classifier" key;
  * the update is scaled by -lr(step), the epoch-granular schedule.
Adam keeps its moments in the storage dtypes of the JAX package: f32, or
bf16 mu (TPU.BF16_MOMENTS: optax.scale_by_adam's mu_dtype, rounded for
storage only), or bf16 mu and nu (TPU.BF16_SECOND_MOMENT:
scale_by_adam_mixed, rounded before use); the arithmetic is f32 in every
case.  torch.optim.Adam keeps its moments in the parameter's dtype, so it is
not used.  The cosine schedule and FROZEN are not ported yet.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from .. import not_ported
from ..config.defaults import Config


def warmup_multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                        warmup_factor: float = 0.01, warmup_iters: int = 10,
                        warmup_method: str = "linear") -> Callable[[int], float]:
    """lr(epoch) per the reference's WarmupMultiStepLR.get_lr."""
    ms = sorted(milestones)

    def lr_at(epoch: int) -> float:
        wf = 1.0
        if epoch < warmup_iters:
            if warmup_method == "constant":
                wf = warmup_factor
            else:
                alpha = epoch / warmup_iters
                wf = warmup_factor * (1 - alpha) + alpha
        return base_lr * wf * gamma ** bisect.bisect_right(ms, epoch)

    return lr_at


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step) = lr_at_epoch(1 + step // steps_per_epoch), as f32 values (the
    reference steps its scheduler once per epoch, the epoch starting at 1)."""
    if cfg.TPU.ENABLE_COSINE_SCHEDULE and cfg.SOLVER.LR_SCHEDULER == "cosine":
        raise not_ported("the cosine LR schedule", "the rest of the modules (timm_cosine_lr)")
    s = cfg.SOLVER
    lr_at = warmup_multistep_lr(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS,
                                s.WARMUP_METHOD)
    max_epochs = s.MAX_EPOCHS + 2
    table = [float(np.float32(lr_at(e))) for e in range(max_epochs)]

    def schedule(step: int) -> float:
        return table[min(1 + int(step) // steps_per_epoch, max_epochs - 1)]

    return schedule


def _f32_pow(base: float, count: int) -> float:
    return float(np.float32(base) ** np.float32(count))


class Optimizer:
    """make_optimizer's chain on named parameters; `step(grads)` updates them
    in place.  `count` is the number of updates taken (optax's counts)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: Config, named_params: Dict[str, torch.nn.Parameter],
                 steps_per_epoch: int):
        s, t = cfg.SOLVER, cfg.TPU
        if cfg.MODEL.FROZEN:
            raise not_ported("MODEL.FROZEN", "the rest of the modules (LoRA / FROZEN)")
        if s.OPTIMIZER_NAME not in ("Adam", "AdamW", "SGD"):
            raise ValueError(f"Unsupported optimizer: {s.OPTIMIZER_NAME}")
        if t.BF16_SECOND_MOMENT and not t.BF16_MOMENTS:
            raise ValueError("TPU.BF16_SECOND_MOMENT requires TPU.BF16_MOMENTS")
        self.name = s.OPTIMIZER_NAME
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.momentum = s.MOMENTUM
        self.params = dict(named_params)
        self.decay = {n: s.WEIGHT_DECAY_BIAS if "bias" in n.rsplit(".", 1)[-1].lower()
                      else s.WEIGHT_DECAY for n in self.params}
        self.fc_scale = {n: 2.0 if s.LARGE_FC_LR and "classifier" in n.lower() else 1.0
                         for n in self.params}
        self.mu_dtype = torch.bfloat16 if t.BF16_MOMENTS else torch.float32
        self.nu_dtype = torch.bfloat16 if t.BF16_SECOND_MOMENT else torch.float32
        self.count = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for n, p in self.params.items():
            if self.name == "SGD":
                self.state[n] = {"trace": torch.zeros_like(p, dtype=torch.float32)}
            else:
                self.state[n] = {"mu": torch.zeros_like(p, dtype=self.mu_dtype),
                                 "nu": torch.zeros_like(p, dtype=self.nu_dtype)}

    def _adam(self, g: torch.Tensor, st: Dict[str, torch.Tensor], c1: float,
              c2: float) -> torch.Tensor:
        mu, nu = st["mu"], st["nu"]
        b1, b2 = self.b1, self.b2
        if self.nu_dtype == torch.bfloat16:  # scale_by_adam_mixed
            m = (b1 * mu.float() + (1.0 - b1) * g).to(mu.dtype)
            v = (b2 * nu.float() + (1.0 - b2) * g.square()).to(nu.dtype)
            u = (m.float() / c1) / (torch.sqrt(v.float() / c2) + self.eps)
        else:  # optax.scale_by_adam, mu_dtype for storage only
            m = (1.0 - b1) * g + b1 * mu.float()
            v = (1.0 - b2) * g.square() + b2 * nu
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        mu.copy_(m)
        nu.copy_(v)
        return u

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update from the f32 gradients of every parameter."""
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - _f32_pow(self.b1, self.count)
        c2 = 1.0 - _f32_pow(self.b2, self.count)
        for n, p in self.params.items():
            g = grads[n].float()
            st = self.state[n]
            if self.name == "AdamW":
                u = self._adam(g, st, c1, c2) + self.decay[n] * p
            else:
                g = g + self.decay[n] * p
                if self.name == "Adam":
                    u = self._adam(g, st, c1, c2)
                else:
                    u = g + self.momentum * st["trace"]
                    st["trace"].copy_(u)
            if self.fc_scale[n] != 1.0:
                u = u * self.fc_scale[n]
            p.add_(u * -lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "state": self.state}

    def load_state_dict(self, sd: dict) -> None:
        if set(sd["state"]) != set(self.state):
            raise ValueError("optimizer state does not name the same parameters")
        self.count = int(sd["count"])
        for n, st in sd["state"].items():
            for k, v in st.items():
                self.state[n][k].copy_(v)


def make_optimizer(cfg: Config, model: torch.nn.Module, steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg, dict(model.named_parameters()), steps_per_epoch)
