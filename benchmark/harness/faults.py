"""Faults planted underneath the timed path, for the readings that set the
upper ends of the limits and for the tests that see ``correct`` fail:

- ``unchanged``: a train step that hands its state back as it found it
  (parameters, optimizer and schedule restored after the real step);
- ``half_batch``: a train step on the first half of the batch, its loss the
  mean over that half;
- ``altered_answer``: a served answer whose best candidate is moved by one
  BEV cell where it is produced.
"""

from __future__ import annotations

import contextlib
import copy

import torch

from benchmark.harness import system

FAULTS = ("unchanged", "half_batch", "altered_answer")


def _unchanged(step):
    def broken(state, batch, generator, device):
        params = [p.detach().clone() for p in state.model.parameters()]
        buffers = [b.detach().clone() for b in state.model.buffers()]
        opt, sched = copy.deepcopy(state.optimizer.state_dict()), copy.deepcopy(state.scheduler.state_dict())
        steps = state.step
        state, aux = step(state, batch, generator, device)
        with torch.no_grad():
            for p, saved in zip(state.model.parameters(), params):
                p.copy_(saved)
            for b, saved in zip(state.model.buffers(), buffers):
                b.copy_(saved)
        state.optimizer.load_state_dict(opt)
        state.scheduler.load_state_dict(sched)
        state.step = steps
        return state, aux

    return broken


def _half(x):
    if isinstance(x, dict):
        return {k: _half(v) for k, v in x.items()}
    return x[:max(1, x.shape[0] // 2)]


def _half_batch(step):
    def broken(state, batch, generator, device):
        return step(state, _half(batch), generator, device)

    return broken


def _altered_answer(step):
    def broken(model, batch, cfg, device):
        aux, xys, keep = step(model, batch, cfg, device)
        xys = xys.clone()
        xys[:, 0, 0] += cfg["world_reduce"]
        return aux, xys, keep

    return broken


@contextlib.contextmanager
def planted(name: str):
    """Within the block the harness's program entry is the broken one."""
    entry, wrap = {"unchanged": ("train_step", _unchanged), "half_batch": ("train_step", _half_batch),
                   "altered_answer": ("eval_step", _altered_answer)}[name]
    inner = getattr(system, entry)
    setattr(system, entry, wrap(inner))
    try:
        yield
    finally:
        setattr(system, entry, inner)
