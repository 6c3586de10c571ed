"""The host data path's native library, port of ``mvdetr_tpu/native``.

``dataio.cpp`` (a copy of ``mvdetr_tpu/native/dataio.cpp`` behind a plain C
interface, plus a cv2-exact bilinear resize) is compiled by the host C++
compiler at first use into ``mvdetr_tpu_torch/_build/<hash>/libdataio.so``,
keyed by a hash of the source and the flags, and loaded with ``ctypes``,
which releases the interpreter lock around each call: the loader's worker
threads warp and resize in parallel. A missing compiler or a failed build
raises; nothing falls back to numpy code with other semantics.

Functions: :func:`splat_gaussian` (target heatmaps), :func:`greedy_nms`,
:func:`warp_image_u8` (the augmentation warp, bilinear),
:func:`resize_u8` (``cv2.resize`` with ``INTER_LINEAR``, the same bytes)
and :func:`png_unfilter` (the row filters of
:func:`mvdetr_tpu_torch.data.png.decode_png`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dataio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# no -march=native and no contraction into FMAs: the same bytes on every x86-64 host
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64 = ctypes.c_int64


def find_compiler() -> str:
    """``$CXX``, else ``g++`` or ``c++`` on ``PATH``; raises when there is none."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("mvdetr_tpu_torch.native: no C++ compiler ($CXX, g++, c++); the data path cannot be built")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / key / "libdataio.so"


def build(timeout_s: float = 300.0) -> Path:
    """Compile ``dataio.cpp`` unless an up-to-date library exists; return its path."""
    lib = library_path()
    if lib.is_file():
        return lib
    cxx = find_compiler()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.{id(lib)}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s)
    (lib.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"mvdetr_tpu_torch.native: building dataio.cpp failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the library, its C entries declared."""
    lib = ctypes.CDLL(str(build()))
    lib.dataio_splat_gaussian.argtypes = [_f32p, _i64, _i64, _i32p, _i64, ctypes.c_double]
    lib.dataio_greedy_nms.argtypes = [_f32p, _f32p, _i64, ctypes.c_double, _u8p]
    lib.dataio_warp_u8.argtypes = [_u8p, _i64, _i64, _f64p, ctypes.c_int, _u8p]
    lib.dataio_resize_u8.argtypes = [_u8p, _i64, _i64, _i64, _u8p, _i64, _i64]
    lib.png_unfilter.argtypes = [_u8p, _i64, _i64, _i64, _u8p]
    for fn in (lib.dataio_splat_gaussian, lib.dataio_greedy_nms, lib.dataio_warp_u8, lib.dataio_resize_u8,
               lib.png_unfilter):
        fn.restype = ctypes.c_int
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"mvdetr_tpu_torch.native.{what}: error code {rc}")


def splat_gaussian(heatmap: np.ndarray, centers: np.ndarray, sigma: float) -> np.ndarray:
    """In-place max-composite Gaussian splats. ``heatmap`` [H, W] f32
    C-contiguous (a view into a larger array is fine), ``centers`` [K, 2]
    int (x, y)."""
    if heatmap.dtype != np.float32 or heatmap.ndim != 2 or not heatmap.flags["C_CONTIGUOUS"]:
        raise ValueError("splat_gaussian: heatmap must be a C-contiguous [H, W] float32 array")
    centers = np.ascontiguousarray(centers, dtype=np.int32).reshape(-1, 2)
    rc = load_library().dataio_splat_gaussian(_ptr(heatmap, _f32p), heatmap.shape[0], heatmap.shape[1],
                                              _ptr(centers, _i32p), len(centers), float(sigma))
    _check(rc, "splat_gaussian")
    return heatmap


def greedy_nms(points: np.ndarray, scores: np.ndarray, thres: float) -> np.ndarray:
    """Greedy distance NMS -> bool keep mask [K] (reference `utils/nms.py:7-44`)."""
    points = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 2)
    scores = np.ascontiguousarray(scores, dtype=np.float32).reshape(-1)
    if len(points) != len(scores):
        raise ValueError(f"greedy_nms: {len(points)} points and {len(scores)} scores")
    keep = np.zeros(len(scores), dtype=np.uint8)
    rc = load_library().dataio_greedy_nms(_ptr(points, _f32p), _ptr(scores, _f32p), len(scores), float(thres),
                                          _ptr(keep, _u8p))
    _check(rc, "greedy_nms")
    return keep.astype(bool)


def warp_image_u8(img: np.ndarray, mat: np.ndarray, border: int = 128) -> np.ndarray:
    """Bilinear perspective warp of a [H, W, 3] uint8 image by the src->dst
    matrix ``mat`` with a constant ``border`` (the augmentation warp,
    `utils/image_utils.py:43-44`)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"warp_image_u8: expected [H, W, 3] uint8, got {img.shape}")
    mat = np.ascontiguousarray(mat, dtype=np.float64).reshape(3, 3)
    out = np.empty_like(img)
    rc = load_library().dataio_warp_u8(_ptr(img, _u8p), img.shape[0], img.shape[1], _ptr(mat, _f64p), int(border),
                                       _ptr(out, _u8p))
    _check(rc, "warp_image_u8")
    return out


def resize_u8(img: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    [H, W, C] uint8 image, with OpenCV's fixed-point arithmetic."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3:
        raise ValueError(f"resize_u8: expected [H, W, C] uint8, got {img.shape}")
    ho, wo = (int(v) for v in out_hw)
    out = np.empty((ho, wo, img.shape[2]), dtype=np.uint8)
    rc = load_library().dataio_resize_u8(_ptr(img, _u8p), img.shape[0], img.shape[1], img.shape[2], _ptr(out, _u8p),
                                         ho, wo)
    _check(rc, "resize_u8")
    return out


def png_unfilter(raw, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: ``raw`` holds ``height`` rows of a filter
    type byte and ``row_bytes`` filtered bytes (an inflated 8-bit,
    non-interlaced IDAT stream; ``bytes`` or a uint8 array), ``bpp`` the
    bytes per pixel. Returns the [height, row_bytes] uint8 rows; raises on
    a short stream or a filter type outside 0-4."""
    src = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray, memoryview)) else raw
    src = np.ascontiguousarray(src, dtype=np.uint8).reshape(-1)
    if src.size != height * (row_bytes + 1):
        raise ValueError(f"png_unfilter: {src.size} bytes for {height} rows of 1 + {row_bytes}")
    out = np.empty((height, row_bytes), dtype=np.uint8)
    rc = load_library().png_unfilter(_ptr(src, _u8p), height, row_bytes, bpp, _ptr(out, _u8p))
    if rc == 2:
        raise ValueError("png_unfilter: a row's filter type is not one of 0-4 (None, Sub, Up, Average, Paeth)")
    _check(rc, "png_unfilter")
    return out
