"""Hold B1 or B2 against another source of the same kernel on the card,
bitwise and in time.

    python -m mvdetr_tpu_torch.scripts.msda_vs_source [--kernel fwd|bwd] [--side query|value|both]
        [--shape flagship|shadow|both] [--sweep] OTHER.cu

``OTHER.cu`` is another revision of ``csrc/msda_windowed_fwd.cu`` (B1, the
default) or ``csrc/msda_windowed_bwd.cu`` (``--kernel bwd``, B2), for
example one taken with ``git show <rev>:mvdetr_tpu_torch/csrc/msda_windowed_fwd.cu``.
Its C entry is ``msda_windowed_fwd_launch``, or for B2
``msda_windowed_bwd_sides_launch``, which runs the side that ``--side``
names (default both) and whose outputs alone are compared. The script reads
from the source which plan arguments the entry takes after the radius
(``vec, tile_y, tile_x``, ``body``, ``levels``, or none) and passes it those
of the plan this source's wrappers use (:func:`_fwd_plan`,
:func:`_query_plan`, :func:`value_levels`). It is built with the package's
``nvcc`` flags into a temporary directory.

Cases (inputs as ``chip_smoke.py`` makes them, numpy seed 0), by
``--shape`` (default both):

- ``flagship``: B=2, L=C=7, 60x180, M=8, D=16, P=4, with R=4 and random
  offsets past the clamp, R=4 and the radial init shifted by integers, and
  R=8, 12 and 16 with random offsets;
- ``shadow``: ``chip_smoke.SHADOW_ATTENTION``, the 8-point shadow path's
  stack of 56 pseudo-levels of one point (B=2, C=7, 60x180, M=8, D=16, P=1,
  R=4), with random offsets past the clamp and with the radial init of 7
  cameras x 8 points shifted by integers, and a ragged stack of
  ``RAGGED_LEVELS`` pseudo-levels (not a multiple of 4) with random offsets.

First it prints one JSON line of each build's registers and spills
(``-Xptxas -v``). For each case it launches both sources through their C
entries with this source's plans, on the same inputs, and reports whether
each output is bitwise equal and the largest difference, whether this
source's wrapper gives the same bits as its entry, the bytes the call must
move and its bound (``chip_smoke.attention_bound``); it times whole launches with CUDA events
in turns (other, this, this, other). ``--sweep`` also times this
source's C entry under other plans, each of which must give the same bits:
for B1 the tiles of SWEEP beside :func:`_fwd_plan`'s, for B2's value side
the pseudo-levels per block of LEVEL_SWEEP beside :func:`value_levels`'.

Prints one JSON line per case. Runs on the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from mvdetr_tpu_torch.ops import kernel_build
from mvdetr_tpu_torch.ops.msda_windowed import (
    _BWD_SIDES,
    _fwd_plan,
    _query_plan,
    _value_align,
    load_bwd_library,
    load_library,
    msda_windowed_bwd,
    msda_windowed_fwd,
    value_levels,
)

FLAGSHIP = dict(b=2, l=7, h=60, w=180, m=8, d=16, p=4, radius=4)
RAGGED_LEVELS = 54  # a shadow stack whose pseudo-levels do not fill the last group of 4
# (tile_y, tile_x) of the sweep: 64, 128 and 256 threads of 16-byte taps at D=16
SWEEP = [(2, 16), (4, 16), (2, 32), (8, 16), (4, 32)]
LEVEL_SWEEP = (1, 4)  # B2's value side: the value planes per block it is built for
ENTRIES = {"fwd": "msda_windowed_fwd_launch", "bwd": "msda_windowed_bwd_sides_launch"}
N_POINTERS = {"fwd": 4, "bwd": 7}
BWD_NAMES = ("g_value", "g_offsets", "g_weights")
SIDE_OUTPUTS = {"query": (1, 2), "value": (0,), "both": (0, 1, 2)}  # which of BWD_NAMES a side writes


def cases(shape: str) -> list[tuple[str, dict]]:
    """``(name, attention_inputs arguments)`` of ``shape``'s cases."""
    import chip_smoke

    flagship = [(f"flagship-{name}", dict(FLAGSHIP, radius=r, integer=integer))
                for name, r, integer in (("random", 4, False), ("integer", 4, True), ("R8", 8, False),
                                         ("R12", 12, False), ("R16", 16, False))]
    shadow = dict(chip_smoke.SHADOW_ATTENTION)
    shadows = [("shadow-random", dict(shadow, integer=False)), ("shadow-integer", dict(shadow, integer=True)),
               (f"shadow-ragged{RAGGED_LEVELS}", dict(shadow, l=RAGGED_LEVELS, init=None, integer=False))]
    return {"flagship": flagship, "shadow": shadows, "both": flagship + shadows}[shape]


def entry_plan_args(src: str, kernel: str) -> list[str]:
    """The plan arguments the source's C entry takes after the radius (before
    ``sides`` and the stream)."""
    params = re.search(ENTRIES[kernel] + r"\(([^)]*)\)", src).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    return [n for n in names[names.index("radius") + 1:] if n not in ("sides", "stream")]


def bind(lib: ctypes.CDLL, kernel: str, plan_args: list[str]):
    fn = getattr(lib, ENTRIES[kernel])
    n_ints = 9 + len(plan_args) + (kernel == "bwd")  # shape, plan, [sides]
    fn.argtypes = [ctypes.c_void_p] * N_POINTERS[kernel] + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of each kernel in a build's ``-Xptxas -v``
    report, by the kernel's template arguments."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(msda_windowed_fwd_kernel|msda_bwd_\w+?_kernel)(I\w*?E)?E", line)
        if m:
            name = m.group(1) + (m.group(2) or "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = {"spill_bytes": int(m.group(1))}
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def build_other(src: Path, out_dir: Path, kernel: str):
    """Compile ``src`` as the package compiles its kernels and load it ->
    ``(entry, the plan arguments it takes, ptxas's report)``."""
    lib_path = out_dir / f"libother_{kernel}.so"
    cmd = [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    plan_args = entry_plan_args(src.read_text(), kernel)
    return bind(ctypes.CDLL(str(lib_path)), kernel, plan_args), plan_args, proc.stdout + proc.stderr


def launch_fwd(entry, v, o, w, radius, plan=()):
    """One launch of a B1 C entry -> ``[out]``; ``plan``: the values of the
    plan arguments it takes."""
    b, l, h, wd, m, d = v.shape
    c, p = o.shape[1], o.shape[6]
    out = torch.empty((b, c, h, wd, m * d), dtype=torch.float32, device=v.device)
    err = entry(v.data_ptr(), o.data_ptr(), w.data_ptr(), out.data_ptr(), b, c, l, h, wd, m, d, p, radius, *plan,
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return [out]


def launch_bwd(entry, v, o, w, g, radius, side: str, plan=()):
    """One launch of ``side`` of a B2 C entry -> the outputs that side
    writes, of ``(g_value, g_offsets, g_weights)``; ``plan``: the values of
    the plan arguments it takes."""
    b, l, h, wd, m, d = v.shape
    c, p = o.shape[1], o.shape[6]
    outs = [torch.empty(t.shape, dtype=torch.float32, device=v.device) for t in (v, o, w)]
    err = entry(v.data_ptr(), o.data_ptr(), w.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in outs), b, c, l, h,
                wd, m, d, p, radius, *plan, _BWD_SIDES[side], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return [outs[i] for i in SIDE_OUTPUTS[side]]


def events_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def this_entry(kernel: str):
    """This source's C entry and the plan arguments it takes."""
    plan_args = entry_plan_args((kernel_build.CSRC_DIR / f"msda_windowed_{kernel}.cu").read_text(), kernel)
    lib = load_library() if kernel == "fwd" else load_bwd_library()
    return bind(lib, kernel, plan_args), plan_args


def sweep_fwd(plan: dict, v, o, w, radius: int, ref: torch.Tensor) -> dict:
    """This B1's time under each tile of SWEEP at the plan's load width and
    body; each must give ``ref``'s bits."""
    entry, args = this_entry("fwd")
    times = {}
    for ty, tx in SWEEP:
        values = dict(plan, tile_y=ty, tile_x=tx)
        run = lambda: launch_fwd(entry, v, o, w, radius, [values[k] for k in args])  # noqa: E731
        if not torch.equal(run()[0], ref):
            raise RuntimeError(f"tile {ty}x{tx} gives other bits than the wrapper's plan")
        times[f"{ty}x{tx}"] = events_ms(run, 20)
    return times


def sweep_levels(plan: dict, v, o, w, g, radius: int, ref: torch.Tensor) -> dict:
    """This B2's value side under each count of pseudo-levels per block of
    LEVEL_SWEEP; each must give ``ref``'s bits."""
    entry, args = this_entry("bwd")
    times = {}
    for levels in LEVEL_SWEEP:
        values = dict(plan, levels=levels)
        run = lambda: launch_bwd(entry, v, o, w, g, radius, "value", [values[k] for k in args])  # noqa: E731
        if not torch.equal(run()[0], ref):
            raise RuntimeError(f"{levels} levels a block give other bits than the wrapper's plan")
        times[str(levels)] = events_ms(run, 10)
    return times


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=Path, help="the other revision's source")
    parser.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
    parser.add_argument("--side", choices=tuple(SIDE_OUTPUTS), default="both",
                        help="B2: the side to launch, time and compare")
    parser.add_argument("--shape", choices=("flagship", "shadow", "both"), default="both")
    parser.add_argument("--sweep", action="store_true",
                        help="also time this kernel under other plans (B1: tiles; B2 with --side value: levels)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("msda_vs_source runs on a CUDA device only")
    import chip_smoke  # the inputs chip_smoke.py makes

    names = ("out",) if args.kernel == "fwd" else tuple(BWD_NAMES[i] for i in SIDE_OUTPUTS[args.side])
    with tempfile.TemporaryDirectory() as tmp:
        other, other_args, other_log = build_other(args.other, Path(tmp), args.kernel)
        this, this_args = this_entry(args.kernel)
        this_log = (kernel_build.library_path(f"msda_windowed_{args.kernel}").parent / "build.log").read_text()
        print(json.dumps({"ptxas": {"other": ptxas_summary(other_log), "this": ptxas_summary(this_log)}}), flush=True)
        rng = np.random.default_rng(0)
        for name, shape in cases(args.shape):
            v, o, w = chip_smoke.attention_inputs(rng, **shape)
            r, p = shape["radius"], shape["p"]
            if args.kernel == "fwd":
                plan = _fwd_plan(v.shape[3], v.shape[4], v.shape[5], p, r, value_align=_value_align(v),
                                 sample_align=min(_value_align(o), _value_align(w)))
                values = {**plan._asdict()}
                run_other = lambda: launch_fwd(other, v, o, w, r, [values[k] for k in other_args])  # noqa: E731
                run_this = lambda: launch_fwd(this, v, o, w, r, [values[k] for k in this_args])  # noqa: E731
                wrapper = [msda_windowed_fwd(v, o, w, r)]
            else:
                b, c, h, wd = o.shape[:4]
                g = torch.from_numpy(rng.standard_normal((b, c, h, wd, v.shape[4] * v.shape[5]),
                                                         dtype=np.float32)).cuda()
                plan = _query_plan(v, o, w, g, r)
                values = {**plan._asdict(), "levels": value_levels(h, wd, v.shape[1], p, r)[0]}
                run_other = lambda: launch_bwd(other, v, o, w, g, r, args.side,  # noqa: E731
                                               [values[k] for k in other_args])
                run_this = lambda: launch_bwd(this, v, o, w, g, r, args.side,  # noqa: E731
                                              [values[k] for k in this_args])
                outs = msda_windowed_bwd(v, o, w, g, r, side=args.side)
                wrapper = [outs[i] for i in SIDE_OUTPUTS[args.side]]
            a, z = run_other(), run_this()
            torch.cuda.synchronize()
            rec = {"case": name, "kernel": args.kernel, "shape": {k: shape[k] for k in ("b", "l", "c", "h", "w",
                                                                                     "m", "d", "p", "radius")
                                                                  if k in shape},
                   "plan": values, "other_plan_args": other_args,
                   "bitwise_equal": {k: bool(torch.equal(x, y)) for k, x, y in zip(names, a, z)},
                   "max_abs_diff": {k: float((x - y).abs().max()) for k, x, y in zip(names, a, z)},
                   "wrapper_equal": all(torch.equal(x, y) for x, y in zip(wrapper, z)),
                   **chip_smoke.attention_bound(args.kernel, args.side, **shape)}
            t_other, t_this = [], []
            for which in ("other", "this", "this", "other"):
                if which == "other":
                    t_other.append(events_ms(run_other, 10))
                else:
                    t_this.append(events_ms(run_this, 10))
            rec.update({"other_ms": t_other, "this_ms": t_this})
            if args.kernel == "bwd":
                rec["side"] = args.side
                if args.sweep and args.side == "value":
                    rec["levels_ms"] = sweep_levels(values, v, o, w, g, r, z[0])
            elif args.sweep:
                rec["tiles_ms"] = sweep_fwd(values, v, o, w, r, z[0])
            rec["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(rec), flush=True)
            del v, o, w, a, z, wrapper
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
