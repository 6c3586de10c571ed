"""Hold B3, the warp backward, against another source of the same kernel on
the card, bitwise and in time.

    python -m mvdetr_tpu_torch.scripts.warp_vs_source OTHER.cu

``OTHER.cu`` is another revision of ``csrc/warp_bwd.cu``, for example one
taken with ``git show <rev>:mvdetr_tpu_torch/csrc/warp_bwd.cu``. It is built
with the package's ``nvcc`` flags into a temporary directory and launched
through its own C entries. The script reads from the source which protocol
they follow:

- ``sorted``: ``warp_bwd_keys_launch``, then a stable ``torch.sort`` of the
  keys (int64 indices), then ``warp_bwd_gather_launch`` (the first design);
- ``stages``: ``warp_bwd_temp_bytes`` sizes the sort's storage and
  ``warp_bwd_launch`` runs all four stages (this source's protocol).

At the flagship coordinates (the bench rig's homographies under the train
batch's augmentation affines, g [14, 43200, 128] bf16, numpy seed 0, as
``chip_smoke.py`` makes them) and at each of ``chip_smoke.py``'s B3 stress
cases, it launches both on the same inputs, reports whether the outputs are
bitwise equal and their largest difference, and times whole calls with CUDA
events in turns (other, this, this, other); at the flagship it also reads
the device time of each source's stages from torch.profiler (``sorted``:
keys, sort, gather; ``stages``: keys, sort, starts, gather), by the names of
their kernels. A call's event time includes the host's launches when the
card is idle; its device time does not.

Prints one JSON line per case. Runs on the card only.
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

    def _keys(self, sx, sy, keys, h, w):
        b, q = sx.shape
        _check(self.lib.warp_bwd_keys_launch(sx.data_ptr(), sy.data_ptr(), keys.data_ptr(), b, q, h, w,
                                             torch.cuda.current_stream().cuda_stream), "keys launch")

    def _gather(self, g, sx, sy, sorted_keys, order, out):
        b, q, c = g.shape
        _, h, w, _ = out.shape
        _check(self.lib.warp_bwd_gather_launch(g.data_ptr(), sx.data_ptr(), sy.data_ptr(), sorted_keys.data_ptr(),
                                               order.data_ptr(), out.data_ptr(), b, q, h, w, c, _DTYPE_CODES[g.dtype],
                                               torch.cuda.current_stream().cuda_stream), "gather launch")

    def __call__(self, g, sx, sy, h, w):
        b, q, c = g.shape
        out = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
        keys = torch.empty(4 * b * q, dtype=torch.int32, device=g.device)
        self._keys(sx, sy, keys, h, w)
        sorted_keys, order = torch.sort(keys, stable=True)
        self._gather(g, sx, sy, sorted_keys, order, out)
        return out


class StagesProtocol:
    """A source with ``warp_bwd_temp_bytes`` and ``warp_bwd_launch`` (this
    source's protocol)."""

    name = "stages"

    def __init__(self, lib: ctypes.CDLL):
        self.lib = warp_ops.bind(lib)

    def __call__(self, g, sx, sy, h, w):
        b, q, c = g.shape
        out = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
        warp_ops.launch(self.lib, g, sx, sy, out, warp_ops.alloc_scratch(self.lib, b, q, h, w, g.device))
        return out


def build_other(src: Path, out_dir: Path):
    """Compile ``src`` as the package compiles its kernels, load it and wrap
    it in the protocol its C entries follow."""
    text = src.read_text()
    if "warp_bwd_gather_launch" in text:
        protocol = SortedProtocol
    elif "warp_bwd_temp_bytes" in text:
        protocol = StagesProtocol
    else:
        raise RuntimeError(f"{src}: neither warp_bwd_gather_launch nor warp_bwd_temp_bytes; unknown C entries")
    lib_path = out_dir / "libother_warp_bwd.so"
    cmd = [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    return protocol(ctypes.CDLL(str(lib_path)))


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=Path, help="the other revision's csrc/warp_bwd.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("warp_vs_source runs on a CUDA device only")
    import chip_smoke  # the inputs chip_smoke.py makes

    rng = np.random.default_rng(0)
    cases = {"flagship": chip_smoke.warp_flagship_inputs(rng), **chip_smoke.warp_stress_cases(rng)}
    with tempfile.TemporaryDirectory() as tmp:
        other = build_other(args.other, Path(tmp))
        for name, case in cases.items():
            g, sx, sy, h, w = (case[k] for k in ("g", "sx", "sy", "h", "w"))
            run_other = lambda: other(g, sx, sy, h, w)  # noqa: E731
            run_this = lambda: warp_ops.warp_bwd(g, sx, sy, h, w)  # noqa: E731
            a, z = run_other(), run_this()
            torch.cuda.synchronize()
            rec = {"case": name, "other_protocol": other.name, "g": list(g.shape), "dtype": str(g.dtype),
                   "hw": [h, w], "bitwise_equal": bool(torch.equal(a, z)),
                   "max_abs_diff": float((a.float() - z.float()).abs().max())}
            runs, times = {"other": run_other, "this": run_this}, {"other": [], "this": []}
            for which in ("other", "this", "this", "other"):
                times[which].append(events_ms(runs[which], 10))
            rec.update({"other_ms": times["other"], "this_ms": times["this"]})
            if name == "flagship":
                rec["other_device_ms"] = chip_smoke.warp_stage_ms(run_other)
                rec["this_device_ms"] = chip_smoke.warp_stage_ms(run_this)
            rec["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(rec), flush=True)
            del a, z
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
