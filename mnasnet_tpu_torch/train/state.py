"""TrainState: what a train step carries besides the model and the optimizer.

Counterpart of ``mnasnet_tpu/train/state.py``. The JAX state is one immutable
pytree of params, batch statistics, optimizer state and PRNG key. In PyTorch
the module owns its parameters and BN statistics and the optimizer
(``train/optim.py``) owns its state, so this holds the rest: the step count
and the ``torch.Generator`` that dropout draws from, both saved and restored
by ``state_dict()`` / ``load_state_dict()``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    generator: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, tx, seed: int = 0) -> "TrainState":
        """Bind the optimizer ``tx`` to ``model`` (fresh optimizer state) and
        seed a dropout generator on the model's device."""
        tx.init(model)
        dev = next(model.parameters()).device
        return cls(step=0, generator=torch.Generator(device=dev).manual_seed(seed))

    def state_dict(self) -> dict:
        return {"step": self.step, "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
