"""Hold B3, the warp backward, against other sources of the same kernel on
the card, bitwise and in time, at the coordinates of each call site.

    python -m mvdetr_tpu_torch.scripts.warp_vs_source OTHER.cu [OTHER.cu ...]
        [--shape flagship|shadow|gather|aio|deform_conv|stress|all] [--reps 10]

Each ``OTHER.cu`` is another revision of ``csrc/warp_bwd.cu``, for example
one taken with ``git show <rev>:mvdetr_tpu_torch/csrc/warp_bwd.cu``, or an
altered copy of one. All are built at once with the package's ``nvcc``
flags into a temporary directory (one ``nvcc`` each, beside this tree's
build) and launched through their own C entries. The script reads from each
source which protocol they follow:

- ``sorted``: ``warp_bwd_keys_launch``, then a stable ``torch.sort`` of the
  keys (int64 indices), then ``warp_bwd_gather_launch`` (the first design);
- ``entries``: ``warp_bwd_temp_bytes`` and ``warp_bwd_launch`` over one
  sort key a (sample, tap) entry, keyed by destination cell (the second
  design), with its scratch sized here;
- ``samples``: ``warp_bwd_body`` beside them, one sort key a sample, keyed
  by its base cell (this tree's design), through ``ops/warp.py``.

Cases, by ``--shape`` (default ``all``), as ``chip_smoke.py`` builds them:
``flagship`` (the bench rig's warp, g [14, 43200, 128] bf16), ``shadow``
(the 8-point shadow coordinates, bf16), ``gather`` (gather mode's value
gradient at the flagship's attention, g [112, 302400, 16], bf16 and f32),
``aio`` (aio's, g [16, 172800, 16], bf16 and f32), ``deform_conv`` (its
input gradient, g [14, 388800, 128] f32) and ``stress``
(``chip_smoke.warp_stress_cases``). For each case and each OTHER it
reports whether the outputs are bitwise equal to this tree's kernel and
their largest difference, and times whole calls with CUDA events in turns
(other, this, this, other; medians of ``--reps``); outside ``stress`` it
also reads each source's device time by stage from torch.profiler
(``chip_smoke.warp_stage_ms``). A call's event time includes the host's
launches when the card is idle; its device time does not.

Prints the card's name and power limit, then one JSON line per case and
OTHER. Runs on the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from mvdetr_tpu_torch.ops import kernel_build
from mvdetr_tpu_torch.ops import warp as warp_ops
from mvdetr_tpu_torch.ops.warp import _DTYPE_CODES

SHAPES = ("flagship", "shadow", "gather", "aio", "deform_conv", "stress")


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


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


class SortedProtocol:
    """A source with ``warp_bwd_keys_launch`` and ``warp_bwd_gather_launch``
    around a stable ``torch.sort``."""

    name = "sorted"

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.warp_bwd_keys_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.warp_bwd_keys_launch.restype = ctypes.c_int
        lib.warp_bwd_gather_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.warp_bwd_gather_launch.restype = ctypes.c_int

    def __call__(self, g, sx, sy, h, w):
        b, q, c = g.shape
        out = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
        keys = torch.empty(4 * b * q, dtype=torch.int32, device=g.device)
        stream = torch.cuda.current_stream().cuda_stream
        _check(self.lib.warp_bwd_keys_launch(sx.data_ptr(), sy.data_ptr(), keys.data_ptr(), b, q, h, w, stream),
               "keys launch")
        sorted_keys, order = torch.sort(keys, stable=True)
        _check(self.lib.warp_bwd_gather_launch(g.data_ptr(), sx.data_ptr(), sy.data_ptr(), sorted_keys.data_ptr(),
                                               order.data_ptr(), out.data_ptr(), b, q, h, w, c, _DTYPE_CODES[g.dtype],
                                               stream), "gather launch")
        return out


class EntriesProtocol:
    """A source with ``warp_bwd_temp_bytes`` and ``warp_bwd_launch`` that
    sorts one key a (sample, tap) entry by destination cell: keys and
    indices ``[2, 4*B*Q]``, starts ``[B*h*w + 1]``, keys over
    ``bit_length(B*h*w)`` bits."""

    name = "entries"

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.warp_bwd_temp_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]
        lib.warp_bwd_temp_bytes.restype = ctypes.c_int
        lib.warp_bwd_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_size_t] + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.warp_bwd_launch.restype = ctypes.c_int

    def __call__(self, g, sx, sy, h, w):
        b, q, c = g.shape
        n, cells = 4 * b * q, b * h * w
        end_bit = max(1, cells.bit_length())
        nbytes = ctypes.c_size_t(0)
        _check(self.lib.warp_bwd_temp_bytes(n, end_bit, ctypes.byref(nbytes)), "temp bytes")
        dev = g.device
        out = torch.empty((b, h, w, c), dtype=g.dtype, device=dev)
        keys = torch.empty((2, n), dtype=torch.int32, device=dev)
        order = torch.empty((2, n), dtype=torch.int32, device=dev)
        start = torch.empty(cells + 1, dtype=torch.int32, device=dev)
        temp = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
        _check(self.lib.warp_bwd_launch(
            g.data_ptr(), sx.data_ptr(), sy.data_ptr(), out.data_ptr(), keys[0].data_ptr(), keys[1].data_ptr(),
            order[0].data_ptr(), order[1].data_ptr(), start.data_ptr(), temp.data_ptr(), temp.numel(), b, q, h, w,
            c, _DTYPE_CODES[g.dtype], end_bit, torch.cuda.current_stream().cuda_stream), "launch")
        return out


class SamplesProtocol:
    """A source with ``warp_bwd_body`` (this tree's protocol), launched
    through ``ops/warp.py``'s scratch and launch."""

    name = "samples"

    def __init__(self, lib: ctypes.CDLL):
        self.lib = warp_ops.bind(lib)

    def __call__(self, g, sx, sy, h, w):
        b, q, c = g.shape
        out = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
        warp_ops.launch(self.lib, g, sx, sy, out, warp_ops.alloc_scratch(self.lib, b, q, h, w, g.device))
        return out


def protocol_of(src: Path):
    """The protocol class whose C entries ``src`` defines."""
    text = src.read_text()
    if "warp_bwd_gather_launch" in text:
        return SortedProtocol
    if "warp_bwd_body" in text:
        return SamplesProtocol
    if "warp_bwd_temp_bytes" in text:
        return EntriesProtocol
    raise RuntimeError(f"{src}: no known C entries (warp_bwd_gather_launch, warp_bwd_body, warp_bwd_temp_bytes)")


def build_others(srcs: list[Path], out_dir: Path) -> list:
    """Compile every source as the package compiles its kernels, all at once
    and beside this tree's build; load each and wrap it in its protocol."""
    procs = []
    for i, src in enumerate(srcs):
        lib_path = out_dir / f"libother{i}_warp_bwd.so"
        cmd = [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib_path), str(src)]
        procs.append((src, lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                      text=True)))
    warp_ops.load_library()  # this tree's build, meanwhile
    others = []
    for src, lib_path, proc in procs:
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{err[-4000:]}")
        others.append(protocol_of(src)(ctypes.CDLL(str(lib_path))))
    return others


def site_cases(shape: str, rng) -> dict:
    """name -> (g, sx, sy, h, w) of one call site, made by ``chip_smoke.py``'s
    input functions (on the card)."""
    import chip_smoke as cs

    def five(c):
        return tuple(c[k] for k in ("g", "sx", "sy", "h", "w"))

    if shape == "flagship":
        return {"flagship": five(cs.warp_flagship_inputs(rng))}
    if shape == "shadow":
        return {"shadow": five(cs.shadow_warp_inputs(rng))}
    if shape in ("gather", "aio"):
        att = cs.GATHER_ATTENTION if shape == "gather" else cs.AIO_ATTENTION
        return {f"{shape}-bf16": five(cs.gather_warp_inputs(rng, att, torch.bfloat16)),
                f"{shape}-f32": five(cs.gather_warp_inputs(rng, att, torch.float32, reach=6.0))}
    if shape == "deform_conv":
        return {"deform_conv-f32": five(cs.deform_conv_warp_inputs(rng))}
    return {name: five(c) for name, c in cs.warp_stress_cases(rng).items()}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("others", type=Path, nargs="+", help="other revisions of csrc/warp_bwd.cu")
    parser.add_argument("--shape", choices=(*SHAPES, "all"), default="all")
    parser.add_argument("--reps", type=int, default=10, help="timed calls a turn")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("warp_vs_source runs on a CUDA device only")
    import chip_smoke  # the inputs chip_smoke.py makes

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        others = build_others(args.others, Path(tmp))
        for shape in SHAPES if args.shape == "all" else (args.shape,):
            cases = site_cases(shape, rng)
            for name, (g, sx, sy, h, w) in cases.items():
                run_this = lambda: warp_ops.warp_bwd(g, sx, sy, h, w)  # noqa: E731
                z = run_this()
                this_stages = None if shape == "stress" else chip_smoke.warp_stage_ms(run_this)
                for src, other in zip(args.others, others):
                    run_other = lambda: other(g, sx, sy, h, w)  # noqa: E731
                    a = run_other()
                    torch.cuda.synchronize()
                    rec = {"case": name, "other": str(src), "other_protocol": other.name, "g": list(g.shape),
                           "dtype": str(g.dtype), "hw": [h, w], "bitwise_equal": bool(torch.equal(a, z)),
                           "max_abs_diff": float((a.float() - z.float()).abs().max())}
                    del a
                    runs, times = {"other": run_other, "this": run_this}, {"other": [], "this": []}
                    for which in ("other", "this", "this", "other"):
                        times[which].append(events_ms(runs[which], args.reps))
                    rec.update({"other_ms": times["other"], "this_ms": times["this"]})
                    if this_stages is not None:
                        rec["other_device_ms"] = chip_smoke.warp_stage_ms(run_other)
                        rec["this_device_ms"] = this_stages
                    rec["card"] = smi
                    print(json.dumps(rec), flush=True)
                del z
            del cases
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
