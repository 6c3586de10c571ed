"""Hold B1 or B2 against another source of the same kernel on the card,
bitwise and in time.

    python -m mvdetr_tpu_torch.scripts.msda_vs_source [--kernel fwd|bwd] [--side query|value|both] [--sweep] OTHER.cu

``OTHER.cu`` is another revision of ``csrc/msda_windowed_fwd.cu`` (B1, the
default) or ``csrc/msda_windowed_bwd.cu`` (``--kernel bwd``, B2), for
example one taken with ``git show <rev>:mvdetr_tpu_torch/csrc/msda_windowed_fwd.cu``.
Its C entry is ``msda_windowed_fwd_launch``, or for B2
``msda_windowed_bwd_sides_launch``, which runs the side that ``--side``
names (default both) and whose outputs alone are compared. Either entry may
take the plan arguments ``vec, tile_y, tile_x`` after the radius (the
script reads which from the source); given them, it gets the plan this
source's wrapper uses (:func:`_fwd_plan`, :func:`_query_plan`), and without
them it plans for itself. It is built with the package's ``nvcc`` flags
into a temporary directory. At the flagship shape (B=2, L=C=7, 60x180, M=8,
D=16, P=4) with R=4 and random offsets past the clamp, R=4 and the radial
init shifted by integers, and R=8, 12 and 16 with random offsets (inputs as
``chip_smoke.py`` makes them, numpy seed 0), it launches both on the same
inputs, reports whether each output is bitwise equal and the largest
difference, and times whole launches with CUDA events in turns (other,
this, this, other). ``--sweep`` (B1) also times this kernel's C entry under
the tiles of SWEEP beside :func:`_fwd_plan`'s, each of which must give the
same bits.

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
    load_library,
    msda_windowed_bwd,
    msda_windowed_fwd,
)

FLAGSHIP = dict(b=2, l=7, h=60, w=180, m=8, d=16, p=4, radius=4)
CASES = [("flagship-random", 4, False), ("flagship-integer", 4, True), ("flagship-R8", 8, False),
         ("flagship-R12", 12, False), ("flagship-R16", 16, False)]
# (tile_y, tile_x) of the sweep: 64, 128 and 256 threads of 16-byte taps at D=16
SWEEP = [(2, 16), (4, 16), (2, 32), (8, 16), (4, 32)]
# ctypes argument types of each C entry: pointers, shape ints, [plan ints], [sides], stream
_FWD, _BWD = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
ENTRIES = {"fwd": "msda_windowed_fwd_launch", "bwd": "msda_windowed_bwd_sides_launch"}
ARGTYPES = {("fwd", False): _FWD + [ctypes.c_void_p], ("fwd", True): _FWD + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            ("bwd", False): _BWD + [ctypes.c_int] + [ctypes.c_void_p],
            ("bwd", True): _BWD + [ctypes.c_int] * 4 + [ctypes.c_void_p]}
BWD_NAMES = ("g_value", "g_offsets", "g_weights")
SIDE_OUTPUTS = {"query": (1, 2), "value": (0,), "both": (0, 1, 2)}  # which of BWD_NAMES a side writes


def build_other(src: Path, out_dir: Path, kernel: str) -> tuple[ctypes.CDLL, bool]:
    """Compile ``src`` as the package compiles its kernels and load it;
    also returns whether its C entry takes a plan."""
    lib_path = out_dir / f"libother_{kernel}.so"
    cmd = [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    takes_plan = bool(re.search(ENTRIES[kernel] + r"\([^)]*\btile_x\b", src.read_text()))
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, ENTRIES[kernel])
    fn.argtypes = ARGTYPES[kernel, takes_plan]
    fn.restype = ctypes.c_int
    return lib, takes_plan


def launch_fwd(lib: ctypes.CDLL, v, o, w, radius, plan=None):
    """One launch of ``lib``'s B1 -> ``[out]``; ``plan`` ``(vec, tile_y,
    tile_x)`` for an entry that takes one."""
    b, l, h, wd, m, d = v.shape
    c, p = o.shape[1], o.shape[6]
    out = torch.empty((b, c, h, wd, m * d), dtype=torch.float32, device=v.device)
    err = lib.msda_windowed_fwd_launch(v.data_ptr(), o.data_ptr(), w.data_ptr(), out.data_ptr(), b, c, l, h, wd, m,
                                       d, p, radius, *(plan or ()), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return [out]


def launch_bwd(lib: ctypes.CDLL, v, o, w, g, radius, side: str, plan=None):
    """One launch of ``side`` of ``lib``'s B2 -> the outputs that side
    writes, of ``(g_value, g_offsets, g_weights)``; ``plan`` ``(vec, tile_y,
    tile_x)`` for an entry that takes one."""
    b, l, h, wd, m, d = v.shape
    c, p = o.shape[1], o.shape[6]
    outs = [torch.empty(t.shape, dtype=torch.float32, device=v.device) for t in (v, o, w)]
    err = lib.msda_windowed_bwd_sides_launch(v.data_ptr(), o.data_ptr(), w.data_ptr(), g.data_ptr(),
                                             *(t.data_ptr() for t in outs), b, c, l, h, wd, m, d, p, radius,
                                             *(plan or ()), _BWD_SIDES[side], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return [outs[i] for i in SIDE_OUTPUTS[side]]


def this_bwd(v, o, w, g, radius, side: str):
    """One launch of ``side`` of this source's B2, through the wrapper -> the
    outputs that side writes."""
    outs = msda_windowed_bwd(v, o, w, g, radius, side=side)
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


def sweep(v, o, w, radius: int, ref: torch.Tensor) -> dict:
    """This kernel's time under each tile of SWEEP, at :func:`_fwd_plan`'s
    load width; each must give ``ref``'s bits."""
    lib = load_library()
    vec = _fwd_plan(v.shape[3], v.shape[4], v.shape[5], o.shape[6], radius, value_align=_value_align(v)).vec
    times = {}
    for ty, tx in SWEEP:
        run = lambda: launch_fwd(lib, v, o, w, radius, (vec, ty, tx))  # noqa: E731
        if not torch.equal(run()[0], ref):
            raise RuntimeError(f"tile {ty}x{tx} gives other bits than the wrapper's plan")
        times[f"{ty}x{tx}"] = events_ms(run, 20)
    return times


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=Path, help="the other revision's source")
    parser.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
    parser.add_argument("--side", choices=tuple(SIDE_OUTPUTS), default="both",
                        help="B2: the side to launch, time and compare")
    parser.add_argument("--sweep", action="store_true", help="B1: also time this kernel under the tiles of SWEEP")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("msda_vs_source runs on a CUDA device only")
    import chip_smoke  # the inputs chip_smoke.py makes

    names = ("out",) if args.kernel == "fwd" else tuple(BWD_NAMES[i] for i in SIDE_OUTPUTS[args.side])
    with tempfile.TemporaryDirectory() as tmp:
        other, takes_plan = build_other(args.other, Path(tmp), args.kernel)
        rng = np.random.default_rng(0)
        for name, r, integer in CASES:
            v, o, w = chip_smoke.attention_inputs(rng, **{**FLAGSHIP, "radius": r}, integer=integer)
            if args.kernel == "fwd":
                plan = _fwd_plan(v.shape[3], v.shape[4], v.shape[5], o.shape[6], r, value_align=_value_align(v))
                run_other = lambda: launch_fwd(other, v, o, w, r, plan[:3] if takes_plan else None)  # noqa: E731
                run_this = lambda: [msda_windowed_fwd(v, o, w, r)]  # noqa: E731
            else:
                b, l, h, wd, m, d = v.shape
                g = torch.from_numpy(rng.standard_normal((b, l, h, wd, m * d), dtype=np.float32)).cuda()
                plan = _query_plan(v, g, o.shape[6], r)
                run_other = lambda: launch_bwd(other, v, o, w, g, r, args.side,  # noqa: E731
                                               plan[:3] if takes_plan else None)
                run_this = lambda: this_bwd(v, o, w, g, r, args.side)  # noqa: E731
            a, z = run_other(), run_this()
            torch.cuda.synchronize()
            rec = {"case": name, "kernel": args.kernel, "radius": r, "plan": plan._asdict(),
                   "bitwise_equal": {k: bool(torch.equal(x, y)) for k, x, y in zip(names, a, z)},
                   "max_abs_diff": {k: float((x - y).abs().max()) for k, x, y in zip(names, a, z)}}
            t_other, t_this = [], []
            for which in ("other", "this", "this", "other"):
                if which == "other":
                    t_other.append(events_ms(run_other, 10))
                else:
                    t_this.append(events_ms(run_this, 10))
            rec.update({"other_ms": t_other, "this_ms": t_this})
            if args.kernel == "bwd":
                rec["side"] = args.side
            elif args.sweep:
                rec["tiles_ms"] = sweep(v, o, w, r, z[0])
            rec["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(rec), flush=True)
            del v, o, w, a, z
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
