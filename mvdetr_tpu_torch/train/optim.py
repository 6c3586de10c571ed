"""Optimizer and schedule, port of ``mvdetr_tpu/train/optim.py``.

Contract (the original MVDeTr's ``main.py:100-115``, as the JAX package
builds it with optax):

- Adam with torch's coupled L2 (``weight_decay`` added to the gradient, as
  ``add_decayed_weights`` -> ``scale_by_adam``), betas (0.95, 0.999), eps 1e-8;
- two parameter groups: the backbone (``base.*``) at ``lr * base_lr_ratio``,
  everything else at ``lr``;
- ``OneCycleLR`` stepped once per batch: cosine warm-up over the first 30% of
  the steps from ``max_lr / 25``, cosine anneal to ``max_lr / 25 / 1e4``, and
  beta1 cycled 0.95 -> 0.85 -> 0.95. Adam's bias correction uses the current
  beta1, as optax's ``inject_hyperparams`` does.

Past ``total_steps - 1`` the JAX schedules hold their last value; torch's
``OneCycleLR`` raises instead, so :func:`schedule_step` stops stepping there.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def param_groups(model: nn.Module, lr: float, base_lr_ratio: float) -> list:
    """``[backbone group, other group]``, keyed by the top-level name ``base``."""
    base, other = [], []
    for name, p in model.named_parameters():
        (base if name.split(".", 1)[0] == "base" else other).append(p)
    return [{"params": base, "lr": lr * base_lr_ratio}, {"params": other, "lr": lr}]


def build_optimizer(model: nn.Module, lr: float, total_steps: int, base_lr_ratio: float = 0.1,
                    weight_decay: float = 1e-4):
    """Two-group Adam and its OneCycle schedule: ``(optimizer, scheduler)``."""
    optimizer = torch.optim.Adam(param_groups(model, lr, base_lr_ratio), lr=lr, betas=(0.95, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=[lr * base_lr_ratio, lr], total_steps=total_steps, pct_start=0.3, anneal_strategy="cos",
        cycle_momentum=True, base_momentum=0.85, max_momentum=0.95, div_factor=25.0, final_div_factor=1e4,
    )
    return optimizer, scheduler


def schedule_step(scheduler) -> None:
    """Advance the schedule by one batch, holding its value after the last
    step of the cycle as the JAX schedules do."""
    if scheduler.last_epoch < scheduler.total_steps - 1:
        scheduler.step()
