"""The train state: the model, the optimizer (momentum buffers and lrs)
and the count of steps taken.

Counterpart of ``pistoseg_tpu/train/state.py``'s ``TrainState``.  PyTorch
updates in place: ``apply_gradients`` steps the optimizer on the
gradients that ``backward`` left in the parameters' ``.grad`` and clears
them.  ``state_dict`` is what ``core/checkpoint.py::save_train_state``
writes for an exact resume.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from pistoseg_tpu_torch.train.optim import set_poly_lr


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def apply_gradients(self) -> None:
        """One optimizer update at the poly lr of step ``self.step``."""
        set_poly_lr(self.optimizer, self.step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
