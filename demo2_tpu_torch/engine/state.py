"""Train state (demo2_tpu/engine/state.py): the step, the model (parameters
and BatchNorm statistics), the optimizer with its state and schedule, and,
when "center" is in MODEL.METRIC_LOSS_TYPE, the center loss's centers with
their SGD."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from ..config.defaults import Config
from ..losses.losses import CenterLossState
from ..models.demo import train_slice_error
from ..solver.optim import CenterSGD, Optimizer, make_optimizer

CENTER_DIM = 2048  # the reference builds its centers 2048 wide whatever the feature


@dataclass
class TrainState:
    model: "torch.nn.Module"  # noqa: F821  (a DeMo)
    optimizer: Optimizer
    history: List[dict] = field(default_factory=list)  # one entry per epoch, not saved
    centers: Optional[torch.Tensor] = None  # (num_classes, CENTER_DIM) f32
    center_optimizer: Optional[CenterSGD] = None

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.optimizer.count

    @property
    def schedule(self) -> Callable[[int], float]:
        return self.optimizer.schedule

    def state_dict(self) -> dict:
        sd = {"step": self.step, "model": self.model.state_dict(),
              "optimizer": self.optimizer.state_dict()}
        if self.centers is not None:
            sd["centers"] = self.centers
        return sd

    def load_state_dict(self, sd: dict) -> None:
        if ("centers" in sd) != (self.centers is not None):
            raise ValueError("the checkpoint and the train state disagree on center loss")
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.centers is not None:
            self.centers.copy_(sd["centers"])
        if self.step != sd["step"]:
            raise ValueError(f"checkpoint step {sd['step']} != optimizer count {self.step}")


def replica_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor a data-parallel rank must hold bitwise equal to the
    others': the model's parameters and buffers, the optimizer's moments,
    the centers."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name, st in state.optimizer.state.items():
        out.update({f"optimizer.{name}.{k}": v for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    if state.centers is not None:
        out["centers"] = state.centers
    return out


def create_train_state(cfg: Config, model, steps_per_epoch: int,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """The optimizer over `model`'s parameters (its weights as they are) and,
    with center loss, standard normal centers on the model's device drawn
    from `generator` (default: a CPU generator seeded SOLVER.SEED)."""
    err = train_slice_error(cfg)
    if err is not None:
        raise err
    state = TrainState(model=model, optimizer=make_optimizer(cfg, model, steps_per_epoch))
    if "center" in cfg.MODEL.METRIC_LOSS_TYPE:
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.SOLVER.SEED)
        device = next(model.parameters()).device
        state.centers = CenterLossState.create(generator, model.num_classes, CENTER_DIM,
                                               device).centers
        state.center_optimizer = CenterSGD(cfg.SOLVER.CENTER_LR)
    return state
