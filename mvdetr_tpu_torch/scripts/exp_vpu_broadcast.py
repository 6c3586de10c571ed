"""The lane broadcast / reduce experiment on the card (kernel B5), counterpart
of ``scripts/exp_vpu_broadcast.py``.

    python -m mvdetr_tpu_torch.scripts.exp_vpu_broadcast            # every variant
    python -m mvdetr_tpu_torch.scripts.exp_vpu_broadcast <variant>  # one of them

For each variant of :mod:`mvdetr_tpu_torch.ops.lane_broadcast` it launches
the CUDA kernel at 81 repetitions and at 1, and prints one line per variant
and size: ``name: ms (us/rep)``, as the TPU script does, where ``us/rep`` is
the 81-repetition time over 81, followed by the time of one repetition's
launch and the cost of each added repetition, ``(ms(81) - ms(1)) / 80``.
Times are medians of CUDA-event timings of single launches after a warm-up.

It runs at two sizes: the TPU script's tile, T = 1104 rows, where a launch
takes about as long as the bound; and T = 151,200, every query of one B2
launch at the flagship shape (B*C*H*W = 2*7*60*180). Inputs are standard
normals from numpy seed 0. It runs on the card only, and raises without one.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mvdetr_tpu_torch.device import resolve_device
from mvdetr_tpu_torch.ops.lane_broadcast import (
    BROADCAST_VARIANTS,
    D,
    LM,
    REPS,
    VARIANTS,
    lane_broadcast,
    lane_reduce,
)

SIZES = (6 * 184, 2 * 7 * 60 * 180)  # the TPU backward tile; the queries of one B2 launch


def make_inputs(t: int, device, seed: int = 0) -> dict:
    """``x [T, LM]`` f32 and ``v [T, LM*D]`` bf16 for the broadcast,
    ``dlk [T, LM*D]`` f32 for the reduce; standard normals, numpy ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, LM), dtype=np.float32)
    dlk = rng.standard_normal((t, LM * D), dtype=np.float32)
    v = rng.standard_normal((t, LM * D), dtype=np.float32)
    return {"x": torch.from_numpy(x).to(device), "v": torch.from_numpy(v).to(device, torch.bfloat16),
            "dlk": torch.from_numpy(dlk).to(device)}


def run(variant: str, inputs: dict, reps: int = REPS) -> torch.Tensor:
    """One launch of ``variant`` on the inputs of :func:`make_inputs`."""
    if variant in BROADCAST_VARIANTS:
        return lane_broadcast(inputs["x"], inputs["v"], variant, reps)
    return lane_reduce(inputs["dlk"], variant, reps)


def launch_ms(fn, iters: int) -> float:
    """Median CUDA-event time of ``iters`` single calls of ``fn`` after one
    warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(only: str | None = None, sizes=SIZES, iters: int = 30, device="cuda") -> dict:
    """Time ``only`` (or every variant) at each size; returns
    ``{(variant, T): {"ms", "ms_1rep", "us_per_added_rep"}}``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("exp_vpu_broadcast times the CUDA kernels: it runs on a CUDA device only")
    if only is not None and only not in VARIANTS:
        raise ValueError(f"unknown variant {only!r}; one of {VARIANTS}")
    results = {}
    for t in sizes:
        inputs = make_inputs(t, dev)
        print(f"== T={t}: broadcast [T,{LM}] -> [T,{LM * D}], reduce [T,{LM * D}] -> [T,{LM}], x{REPS} ==")
        for name in VARIANTS:
            if only not in (None, name):
                continue
            ms = launch_ms(lambda: run(name, inputs, REPS), iters)
            ms1 = launch_ms(lambda: run(name, inputs, 1), iters)
            added = (ms - ms1) / (REPS - 1) * 1e3
            results[(name, t)] = {"ms": ms, "ms_1rep": ms1, "us_per_added_rep": added}
            print(f"{name:14s}: {ms:8.4f} ms  ({ms / REPS * 1e3:7.3f} us/rep; 1 rep {ms1:.4f} ms, "
                  f"{added:.3f} us per added rep)")
        del inputs
    return results


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
