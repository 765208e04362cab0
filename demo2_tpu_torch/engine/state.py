"""Train state (demo2_tpu/engine/state.py): the step, the model (parameters
and BatchNorm statistics) and the optimizer with its state and schedule."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List

from ..config.defaults import Config
from ..models.demo import train_slice_error
from ..solver.optim import Optimizer, make_optimizer


@dataclass
class TrainState:
    model: "torch.nn.Module"  # noqa: F821  (a DeMo)
    optimizer: Optimizer
    history: List[dict] = field(default_factory=list)  # one entry per epoch, not saved

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.optimizer.count

    @property
    def schedule(self) -> Callable[[int], float]:
        return self.optimizer.schedule

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.step != sd["step"]:
            raise ValueError(f"checkpoint step {sd['step']} != optimizer count {self.step}")


def create_train_state(cfg: Config, model, steps_per_epoch: int) -> TrainState:
    """The optimizer over `model`'s parameters (its weights as they are)."""
    err = train_slice_error(cfg)
    if err is not None:
        raise err
    return TrainState(model=model, optimizer=make_optimizer(cfg, model, steps_per_epoch))
