"""Profiling helpers, port of ``mvdetr_tpu/utils/profiling.py``.

The original MVDeTr's observability is manual wall-clock accumulators
(``multiview_detector/trainer.py:40-43,68-82``); the JAX package adds a
``jax.profiler`` device trace. Here :func:`device_trace` is a
``torch.profiler`` run (the host ops of every thread and, on the card, its
kernels) that writes a Chrome trace (``trace.json``, open it in
``chrome://tracing`` or Perfetto) and a table of the device time by kernel
(``kernels.txt``) into ``logdir``.

:func:`span` marks the program's phases in such a trace: ``mvdetr:*``
annotations on the thread that runs the phase, on the clock the profiler
aligns with the card's, around the kernels launched inside them. Training:
``mvdetr:train_step`` holds ``mvdetr:upload``, ``mvdetr:train.forward``
(the model and the loss), ``mvdetr:train.backward`` (with the gradients'
reduction across ranks) and ``mvdetr:train.optimizer`` (``zero_grad``; the
Adam and OneCycle steps). Serving: ``mvdetr:eval_step`` holds
``mvdetr:upload``, the model, ``mvdetr:decode`` (sigmoid, decode, top-K)
and ``mvdetr:nms``. Inside the model: ``mvdetr:trunk`` (``model.base``),
``mvdetr:norm`` (each ``BatchNorm2d`` and ``LayerNorm``), ``mvdetr:warp``
(the homographies and the BEV warp) and ``mvdetr:attention`` (each
``MSDeformAttn``), which in ``warped`` mode holds ``mvdetr:shadow_warp``
(the resample of the value at the shadow maps). The card's feed:
``mvdetr:feed.stage`` on the producer thread of
:func:`~mvdetr_tpu_torch.data.prefetch.prefetch_to_device` (a
batch's pinned copies and uploads) and ``mvdetr:feed.wait`` on the
consumer's (the wait for the next staged batch). No span opens inside a
backward pass, but for the trunk's forward that ``--remat_backbone`` runs
again there: the profiler ties backward kernels to their forward op by
autograd's sequence numbers. The spans carry no argument: a
``record_function``'s string argument does not reach the exported trace.
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` around the ``with`` block
    while a profiler runs; otherwise a shared no-op context, which costs one
    check of the profiler's flag and dispatches no op."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the body with ``torch.profiler``; on exit write
    ``logdir/trace.json`` and ``logdir/kernels.txt``. Host ops of every
    thread are recorded, so the feed's producer thread shows too."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort_by = "self_device_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(os.path.join(logdir, "kernels.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by=sort_by, row_limit=60))
