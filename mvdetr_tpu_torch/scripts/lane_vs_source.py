"""Hold B5, the lane broadcast / reduce experiment, against other sources of
the same kernel on the card, in agreement and in time.

    python -m mvdetr_tpu_torch.scripts.lane_vs_source OTHER.cu [OTHER.cu ...]

Each ``OTHER.cu`` is another revision of ``csrc/lane_broadcast.cu`` (for
example ``git show <rev>:mvdetr_tpu_torch/csrc/lane_broadcast.cu``), or an
altered copy of this one. It is built with the package's ``nvcc`` flags into
a temporary directory and launched through its own C entries
``lane_broadcast_launch`` and ``lane_reduce_launch``, whose arguments and
variant codes every revision shares. At the experiment's two sizes
(``exp_vpu_broadcast.SIZES``: T = 1104 and 151,200 rows, its inputs, numpy
seed 0), for each variant and each OTHER, it reports the largest difference
from this source's output and each one's error against the plain version,
and times both at 81 repetitions and at 1 in turns (other, this, this,
other), each a median of ``--iters`` CUDA-event timings of single launches
after a warm-up; ``us_per_added_rep`` is ``(ms(81) - ms(1)) / 80``.

Prints one JSON line per size, variant and OTHER. Runs on the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from mvdetr_tpu_torch.ops import kernel_build
from mvdetr_tpu_torch.ops import lane_broadcast as lb
from mvdetr_tpu_torch.scripts import exp_vpu_broadcast as exp


def build_other(src: Path, out_dir: Path) -> ctypes.CDLL:
    """Compile ``src`` as the package compiles its kernels and load it."""
    lib_path = out_dir / f"libother_{src.stem}.so"
    cmd = [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    return lb.bind(ctypes.CDLL(str(lib_path)))


def launch(lib: ctypes.CDLL, variant: str, inputs: dict, reps: int) -> torch.Tensor:
    """One launch of ``variant`` through ``lib``'s C entry on the inputs of
    :func:`exp_vpu_broadcast.make_inputs`."""
    if variant in lb.BROADCAST_VARIANTS:
        return lb.launch(lib, variant, inputs["x"], inputs["v"], reps)
    return lb.launch(lib, variant, inputs["dlk"], None, reps)


def in_turns(run_other, run_this, iters: int) -> dict:
    """Medians of ``iters`` launches of each, in turns other, this, this, other."""
    runs, times = {"other": run_other, "this": run_this}, {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        times[which].append(exp.launch_ms(runs[which], iters))
    return times


def plain_of(variant: str, inputs: dict) -> torch.Tensor:
    """The plain version of ``variant`` at ``REPS`` repetitions."""
    if variant in lb.BROADCAST_VARIANTS:
        return lb.lane_broadcast_plain(inputs["x"], inputs["v"], variant)
    return lb.lane_reduce_plain(inputs["dlk"], variant)


def compare(other: ctypes.CDLL, inputs: dict, variant: str, plain: torch.Tensor, iters: int) -> dict:
    """``other`` against this source on one variant: agreement (with each
    other and with ``plain``) and times at ``REPS`` and at 1 repetition, in
    turns."""
    this = lb.load_library()
    a, z = launch(other, variant, inputs, lb.REPS), launch(this, variant, inputs, lb.REPS)
    torch.cuda.synchronize()
    rec = {"max_abs_diff": float((a - z).abs().max()), "other_err": float((a - plain).abs().max()),
           "this_err": float((z - plain).abs().max()), "scale": float(plain.abs().max())}
    for reps, key in ((lb.REPS, "ms"), (1, "ms_1rep")):
        times = in_turns(functools.partial(launch, other, variant, inputs, reps),
                         functools.partial(launch, this, variant, inputs, reps), iters)
        rec[f"other_{key}"], rec[f"this_{key}"] = times["other"], times["this"]
    for who in ("other", "this"):
        added = [(m - m1) / (lb.REPS - 1) * 1e3 for m, m1 in zip(rec[f"{who}_ms"], rec[f"{who}_ms_1rep"])]
        rec[f"{who}_us_per_added_rep"] = added
    return rec


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("others", type=Path, nargs="+", help="other revisions or altered copies of the source")
    parser.add_argument("--iters", type=int, default=20, help="launches a median is taken over")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("lane_vs_source runs on a CUDA device only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(args.others)) as pool:  # one nvcc a source, all at once
            libs = list(pool.map(lambda src: build_other(src, Path(tmp)), args.others))
        others = dict(zip(map(str, args.others), libs))
        for t in exp.SIZES:
            inputs = exp.make_inputs(t, "cuda")
            for variant in lb.VARIANTS:
                plain = plain_of(variant, inputs)
                for name, other in others.items():
                    rec = {"T": t, "variant": variant, "other": name,
                           **compare(other, inputs, variant, plain, args.iters),
                           "device": torch.cuda.get_device_name(0)}
                    print(json.dumps(rec), flush=True)
                del plain
            del inputs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
