"""Checkpoints, port of ``mvdetr_tpu/train/checkpoint.py``.

As in the JAX package the full train state is saved, so training resumes
exactly: the model's state_dict (parameters and BatchNorm statistics), the
optimizer's (Adam moments and step counts), the schedule's and ``step``, in
one ``torch.save`` file ``<ckpt_dir>/<step>/state.pt``. A weights-only
restore (the original MVDeTr's ``--resume``: reload the weights, then test)
loads the model's state_dict and leaves the optimizer and the schedule as
they are. Files load with ``torch.load(weights_only=True)``, onto the
device the state lives on. orbax's on-disk format (the JAX package's) is not
read or written.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, state, step: Optional[int] = None) -> str:
    """Write the full train state under ``ckpt_dir/<step>`` (default: the
    state's step); returns that directory."""
    step = int(state.step) if step is None else int(step)
    out = os.path.join(os.path.abspath(ckpt_dir), str(step))
    os.makedirs(out, exist_ok=True)
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "scheduler": state.scheduler.state_dict(), "step": int(state.step)}
    tmp = os.path.join(out, f".{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(out, STATE_FILE))  # a crash never leaves a partial checkpoint
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step saved under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir)
             if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE))]
    return max(steps) if steps else None


def _load(ckpt_dir: str, state, step: Optional[int]) -> dict:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    device = next(state.model.parameters()).device
    return torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), map_location=device, weights_only=True)


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Restore a full train state saved by :func:`save_checkpoint` (the
    latest step unless ``step`` is given) into ``state``, in place; returns it."""
    payload = _load(ckpt_dir, state, step)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])
    return state


def restore_weights(ckpt_dir: str, state, step: Optional[int] = None):
    """Weights-only restore (parameters and BatchNorm statistics); the
    optimizer, the schedule and ``step`` stay as they are."""
    state.model.load_state_dict(_load(ckpt_dir, state, step)["model"])
    return state
