"""Train state and optimizer (port of ``usip_tpu/train/state.py``).

usip_tpu keeps an immutable pytree of params, batch statistics and optimizer
state; the port keeps the module (parameters and BatchNorm buffers), a
``torch.optim.Adam`` and the step count, and the train step updates them in
place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


def make_adam(params, lr: float) -> torch.optim.Adam:
    """Adam(lr, betas (0.9, 0.999), eps 1e-8, no weight decay), usip_tpu's
    ``make_adam`` (the reference's keypoint_detector.py:42-45)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (the reference mutates
    param_groups, keypoint_detector.py:356-366)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def lr_at_epoch(base_lr: float, epoch: int, decay_step: int,
                decay_ratio: float, clip: float = 1e-5) -> float:
    """Stepwise schedule: ``decay_ratio`` every ``decay_step`` epochs,
    floored at ``clip``."""
    lr = base_lr * (decay_ratio ** (epoch // max(decay_step, 1)))
    return max(lr, clip)


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    the number of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, lr: float) -> "TrainState":
        return cls(model, make_adam(model.parameters(), lr))
