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
not used.  `CenterSGD` is the center loss's plain SGD.  FROZEN is not ported
yet.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

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


def warmup_linear_lr(base_lr: float, max_epochs: int, warmup_factor: float = 0.01,
                     warmup_iters: int = 0, warmup_method: str = "linear",
                     min_lr: float = 0.0) -> Callable[[int], float]:
    """lr(epoch) per the reference's WarmupLinearLR: the warmup factor, then
    a linear decay to 0 over the epochs after the warmup, floored at min_lr."""

    def lr_at(epoch: int) -> float:
        wf = 1.0
        if epoch < warmup_iters:
            if warmup_method == "constant":
                wf = warmup_factor
            else:
                alpha = epoch / float(warmup_iters)
                wf = warmup_factor * (1 - alpha) + alpha
        if epoch <= warmup_iters:
            decay = 1.0
        else:
            eff = max_epochs - warmup_iters
            decay = 0.0 if eff <= 1 else max(1.0 - (epoch - warmup_iters - 1) / float(eff - 1),
                                             0.0)
        return max(min_lr, base_lr * wf * decay)

    return lr_at


def timm_cosine_lr(base_lr: float, t_initial: int, lr_min: float = 0.0, decay_rate: float = 1.0,
                   warmup_t: int = 0, warmup_lr_init: float = 0.0, cycle_limit: int = 0,
                   noise_range_t: Optional[Tuple[int, int]] = None, noise_pct: float = 0.67,
                   noise_seed: int = 42) -> Callable[[int], float]:
    """lr(epoch) per timm's CosineLRScheduler as the reference's commented-out
    factory builds it (t_mul 1, no warmup prefix): a linear warmup from
    warmup_lr_init, then cosine cycles of t_initial epochs, each decayed by
    decay_rate, lr_min after cycle_limit cycles.  For t in noise_range_t the
    lr is multiplied by 1 + noise, the noise a N(0, 1) draw of a generator
    seeded noise_seed + t, drawn again until |noise| < noise_pct (timm's
    normal noise)."""

    def lr_at(t: int) -> float:
        if warmup_t and t < warmup_t:
            lr = warmup_lr_init + t * (base_lr - warmup_lr_init) / warmup_t
        else:
            i = t // t_initial
            t_curr = t - t_initial * i
            gamma = decay_rate ** i
            if cycle_limit == 0 or i < cycle_limit:
                lr = lr_min * gamma + 0.5 * (base_lr * gamma - lr_min * gamma) * (
                    1 + math.cos(math.pi * t_curr / t_initial))
            else:
                lr = lr_min
        if noise_range_t is not None and noise_range_t[0] <= t < noise_range_t[1]:
            g = torch.Generator().manual_seed(noise_seed + t)
            while True:
                noise = torch.randn(1, generator=g).item()
                if abs(noise) < noise_pct:
                    break
            lr = lr + lr * noise
        return lr

    return lr_at


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step) = lr_at_epoch(1 + step // steps_per_epoch), as f32 values (the
    reference steps its scheduler once per epoch, the epoch starting at 1).
    The rule is WarmupMultiStepLR, which the reference's create_scheduler
    always returns; with TPU.ENABLE_COSINE_SCHEDULE and SOLVER.LR_SCHEDULER
    'cosine' it is the recipe of its commented-out cosine block: lr_min
    0.001 * base, warmup_lr_init 0.1 * base, decay_rate 0.1, one cycle, noise
    over every epoch."""
    s = cfg.SOLVER
    if cfg.TPU.ENABLE_COSINE_SCHEDULE and s.LR_SCHEDULER == "cosine":
        lr_at = timm_cosine_lr(s.BASE_LR, t_initial=s.MAX_EPOCHS, lr_min=0.001 * s.BASE_LR,
                               decay_rate=0.1, warmup_t=s.WARMUP_ITERS,
                               warmup_lr_init=0.1 * s.BASE_LR, cycle_limit=1,
                               noise_range_t=(0, s.MAX_EPOCHS))
    else:
        lr_at = warmup_multistep_lr(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_FACTOR,
                                    s.WARMUP_ITERS, s.WARMUP_METHOD)
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


class CenterSGD:
    """optax.sgd(SOLVER.CENTER_LR) on the center loss's centers:
    c <- c - lr * g, in place.  It keeps no state."""

    def __init__(self, lr: float):
        self.lr = lr

    @torch.no_grad()
    def step(self, centers: torch.Tensor, grad: torch.Tensor) -> None:
        centers.add_(grad * -self.lr)


def make_optimizer(cfg: Config, model: torch.nn.Module, steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg, dict(model.named_parameters()), steps_per_epoch)
