"""Build the port's CUDA kernels at first use.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library that ``ctypes`` loads. The
library lands in ``mvdetr_tpu_torch/_build/<hash>/``, keyed by a hash of the
source and the compiler flags, so an edited source rebuilds and an unchanged
one is reused. Building only ever happens from the sources in the package; a
missing ``nvcc`` or a failed build raises, and nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or the
    toolkit's default prefix. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), DEFAULT_CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(f"mvdetr_tpu_torch: nvcc not found (PATH, CUDA_HOME, CUDA_PATH, {DEFAULT_CUDA_HOME}); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (built or not)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / key / f"lib{name}.so"


def build(name: str, timeout_s: float = 600.0) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists, and
    return the library's path. The compiler's report (registers, spills) is
    kept beside it in ``build.log``."""
    lib = library_path(name)
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s)
    (lib.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"mvdetr_tpu_torch: nvcc failed for {name}.cu:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent builder never loads a partial file
    return lib
