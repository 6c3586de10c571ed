"""Train state, port of ``mvdetr_tpu/train/state.py:15-54``.

A :class:`TrainState` holds the model (its parameters and BatchNorm running
statistics), the optimizer, the schedule and the step count. Loading a
pretrained backbone or full converted weights (``backbone_variables``,
``load_full_variables``) waits for ROADMAP item A7; ``model.load_state_dict``
with :func:`mvdetr_tpu_torch.interop.from_jax_variables` covers carrying JAX
weights over today.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from mvdetr_tpu_torch.train.optim import build_optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_train_state(model: nn.Module, lr: float = 5e-4, total_steps: int = 1000, base_lr_ratio: float = 0.1,
                       weight_decay: float = 1e-4) -> TrainState:
    """Wrap ``model`` (already initialised, on its device) with the
    two-group Adam and OneCycle schedule of :mod:`~mvdetr_tpu_torch.train.optim`."""
    optimizer, scheduler = build_optimizer(model, lr, total_steps, base_lr_ratio, weight_decay)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)
