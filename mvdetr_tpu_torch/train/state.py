"""Train state, port of ``mvdetr_tpu/train/state.py``.

A :class:`TrainState` holds the model (its parameters and BatchNorm running
statistics), the optimizer, the schedule and the step count.

- ``create_train_state(backbone_variables=)``: the ImageNet init of the trunk
  from a torchvision ``resnet18`` state dict (or the ``.npz`` that
  ``scripts/prepare_backbone.py`` writes, which holds the same keys), or a
  ``vgg11`` one for a VGG-11 model, mapped onto ``base.*``: the counterpart
  of ``load_torchvision_state_dict`` (`mvdetr_tpu/models/resnet.py:126`) and
  ``load_torchvision_vgg11_state_dict``.
- :func:`load_full_variables`: JAX-shaped numpy variables of the whole model
  through :func:`mvdetr_tpu_torch.interop.from_jax_variables`;
- :func:`load_state_dict_checked`: a state dict under the model's own names
  (a reference checkpoint's, :func:`mvdetr_tpu_torch.interop.load_torch_checkpoint`).

All loads are strict and shape-checked: a converted tree that does not
match the model raises instead of training from garbage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
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
                       weight_decay: float = 1e-4, backbone_variables: Optional[Mapping] = None) -> TrainState:
    """Wrap ``model`` (already initialised, on its device) with the
    two-group Adam and OneCycle schedule of :mod:`~mvdetr_tpu_torch.train.optim`;
    ``backbone_variables``, a torchvision state dict of the model's backbone
    (tensors or numpy arrays), replaces the trunk's parameters and statistics
    first."""
    if backbone_variables is not None:
        load_backbone(model, backbone_variables)
    optimizer, scheduler = build_optimizer(model, lr, total_steps, base_lr_ratio, weight_decay)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)


def torchvision_to_base(state_dict: Mapping) -> dict:
    """torchvision ``resnet18`` keys -> the trunk's ``base.*`` keys:
    ``conv1`` -> ``base.0``, ``bn1`` -> ``base.1``, ``layer{s}.{b}`` ->
    ``base.{3+s}.{b}``; ``fc.*`` and ``num_batches_tracked`` are dropped."""
    out = {}
    for key, value in state_dict.items():
        head, _, rest = key.partition(".")
        if head == "fc" or key.endswith("num_batches_tracked"):
            continue
        if head == "conv1":
            name = f"base.0.{rest}"
        elif head == "bn1":
            name = f"base.1.{rest}"
        elif head.startswith("layer") and head[5:].isdigit():
            name = f"base.{3 + int(head[5:])}.{rest}"
        else:
            raise ValueError(f"unexpected key {key!r} in a torchvision resnet18 state dict")
        out[name] = torch.as_tensor(np.asarray(value.detach().cpu() if hasattr(value, "detach") else value))
    return out


def load_backbone(model: nn.Module, state_dict: Mapping) -> None:
    """Load a torchvision state dict into ``model.base``, ``resnet18``'s or,
    for a VGG-11 model, ``vgg11``'s: every parameter and running statistic
    of the trunk, shape-checked."""
    if getattr(model, "arch", "resnet18") == "vgg11":
        from mvdetr_tpu_torch.models.vgg import load_torchvision_vgg11_state_dict

        loaded = load_torchvision_vgg11_state_dict(state_dict)
    else:
        loaded = torchvision_to_base(state_dict)
    _load_checked(model, loaded, prefix="base.", what="backbone")


def load_full_variables(state: TrainState, variables: dict) -> TrainState:
    """Replace every parameter and BatchNorm statistic of ``state.model``
    with JAX-shaped numpy ``variables`` (``{"params", "batch_stats"}`` of a
    JAX ``MVDeTr``), converted by ``interop.from_jax_variables``, strictly
    and shape-checked. The optimizer state is left as it is."""
    from mvdetr_tpu_torch.interop import from_jax_variables

    device = next(state.model.parameters()).device
    _load_checked(state.model, from_jax_variables(variables, device=device), prefix="", what="variables")
    return state


def load_state_dict_checked(model: nn.Module, state_dict: Mapping, what: str = "state dict") -> None:
    """Copy ``state_dict`` (the model's own names) into every parameter and
    BatchNorm statistic of ``model``, strictly and shape-checked."""
    _load_checked(model, state_dict, prefix="", what=what)


def _load_checked(model: nn.Module, loaded: Mapping, prefix: str, what: str) -> None:
    """Copy ``loaded`` into the entries of ``model.state_dict()`` under
    ``prefix``; raises unless the keys and shapes match exactly (the
    ``num_batches_tracked`` counters excepted)."""
    own = {k: v for k, v in model.state_dict().items()
           if k.startswith(prefix) and not k.endswith("num_batches_tracked")}
    loaded = {k: v for k, v in loaded.items() if not k.endswith("num_batches_tracked")}
    missing, unexpected = sorted(set(own) - set(loaded)), sorted(set(loaded) - set(own))
    shapes = sorted(k for k in set(own) & set(loaded) if tuple(own[k].shape) != tuple(loaded[k].shape))
    if missing or unexpected or shapes:
        raise ValueError(f"pretrained {what} do not match the model: missing {missing[:8]}, unexpected "
                         f"{unexpected[:8]}, shapes differ at {shapes[:8]}")
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(torch.as_tensor(loaded[k]).to(v.device, v.dtype))
