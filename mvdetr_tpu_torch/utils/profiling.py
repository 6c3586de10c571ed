"""Profiling helpers, port of ``mvdetr_tpu/utils/profiling.py``.

The original MVDeTr's observability is manual wall-clock accumulators
(``multiview_detector/trainer.py:40-43,68-82``); the JAX package adds a
``jax.profiler`` device trace. Here :func:`device_trace` is a
``torch.profiler`` run (host ops and, on the card, its kernels) that writes a
Chrome trace (``trace.json``, open it in ``chrome://tracing`` or Perfetto)
and a table of the device time by kernel (``kernels.txt``) into ``logdir``.
:class:`StepTimer` is copied unchanged.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the body with ``torch.profiler``; on exit write
    ``logdir/trace.json`` and ``logdir/kernels.txt``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort_by = "self_device_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(os.path.join(logdir, "kernels.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by=sort_by, row_limit=60))


class StepTimer:
    """Rolling wall-clock timer for steady-state step rates."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._last = None

    def tick(self):
        now = time.time()
        if self._last is not None:
            self.count += 1
            if self.count > self.warmup:
                self.total += now - self._last
        self._last = now

    @property
    def mean_step_s(self) -> float:
        steps = self.count - self.warmup
        return self.total / steps if steps > 0 else float("nan")

    @property
    def steps_per_s(self) -> float:
        s = self.mean_step_s
        return 1.0 / s if s and s == s and s > 0 else 0.0
