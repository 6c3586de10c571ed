"""Hold B2 (``csrc/msda_windowed_bwd.cu``) against another source of the same
kernel on the card, bitwise and in time.

    python -m mvdetr_tpu_torch.scripts.b2_vs_source OTHER.cu

``OTHER.cu`` is another revision of ``msda_windowed_bwd.cu`` with the same C
interface (``msda_windowed_bwd_launch``), for example one taken with
``git show <rev>:mvdetr_tpu_torch/csrc/msda_windowed_bwd.cu``. It is built
with the package's ``nvcc`` flags into a temporary directory. At the
flagship shape (B=2, L=C=7, 60x180, M=8, D=16, P=4, R=4), with random
offsets past the clamp and with the radial init shifted by integers (inputs
as ``chip_smoke.py`` makes them, numpy seed 0), it launches both on the
same inputs, reports whether each of the three cotangents is bitwise equal,
and times whole launches with CUDA events in turns (other, this, this,
other). Prints one JSON line per case. Runs on the card only.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from mvdetr_tpu_torch.ops import kernel_build
from mvdetr_tpu_torch.ops.msda_windowed import load_bwd_library, msda_windowed_bwd

FLAGSHIP = dict(b=2, l=7, h=60, w=180, m=8, d=16, p=4, radius=4)


def build_other(src: Path, out_dir: Path) -> ctypes.CDLL:
    """Compile ``src`` as the package compiles its kernels and load it."""
    lib_path = out_dir / "libother_bwd.so"
    cmd = [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    lib.msda_windowed_bwd_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.msda_windowed_bwd_launch.restype = ctypes.c_int
    return lib


def launch(lib: ctypes.CDLL, v, o, w, g, radius):
    """One launch of ``lib``'s B2 -> ``(g_value, g_offsets, g_weights)``."""
    b, l, h, wd, m, d = v.shape
    c, p = o.shape[1], o.shape[6]
    outs = [torch.empty(t.shape, dtype=torch.float32, device=v.device) for t in (v, o, w)]
    err = lib.msda_windowed_bwd_launch(v.data_ptr(), o.data_ptr(), w.data_ptr(), g.data_ptr(),
                                       *(t.data_ptr() for t in outs), b, c, l, h, wd, m, d, p, radius,
                                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return outs


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


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        raise RuntimeError("b2_vs_source runs on a CUDA device only")
    import chip_smoke  # the inputs chip_smoke.py makes

    ours = load_bwd_library()
    with tempfile.TemporaryDirectory() as tmp:
        other = build_other(Path(argv[0]), Path(tmp))
        rng = np.random.default_rng(0)
        for name, integer in (("flagship-random", False), ("flagship-integer", True)):
            v, o, w = chip_smoke.attention_inputs(rng, **FLAGSHIP, integer=integer)
            b, l, h, wd, m, d = v.shape
            g = torch.from_numpy(rng.standard_normal((b, l, h, wd, m * d), dtype=np.float32)).cuda()
            r = FLAGSHIP["radius"]
            a = launch(other, v, o, w, g, r)
            z = launch(ours, v, o, w, g, r)
            torch.cuda.synchronize()
            equal = {k: bool(torch.equal(x, y)) for k, x, y in zip(("g_value", "g_offsets", "g_weights"), a, z)}
            diff = {k: float((x - y).abs().max()) for k, x, y in zip(("g_value", "g_offsets", "g_weights"), a, z)}
            t_other, t_this = [], []
            for which in ("other", "this", "this", "other"):
                if which == "other":
                    t_other.append(events_ms(lambda: launch(other, v, o, w, g, r), 10))
                else:
                    t_this.append(events_ms(lambda: msda_windowed_bwd(v, o, w, g, r), 10))
            print(json.dumps({"case": name, "bitwise_equal": equal, "max_abs_diff": diff, "other_ms": t_other,
                              "this_ms": t_this, "device": torch.cuda.get_device_name(0)}), flush=True)
            del v, o, w, g, a, z
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
