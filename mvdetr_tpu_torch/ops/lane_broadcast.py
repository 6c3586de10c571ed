"""The lane broadcast and reduce experiment, port of
``scripts/exp_vpu_broadcast.py`` (kernel B5).

In the windowed-attention kernels (B1, B2) each (level, head) weight is
broadcast over the ``D = 16`` channel lanes of its head, and per-channel
products are summed back over those lanes. The TPU script times six ways of
doing the two steps, each repeated ``REPS = 81`` times (the 9x9 shift loop)
over a ``[T, .]`` tile, with ``x + i`` recomputed in every repetition:

- broadcast, ``x [T, LM]`` f32, ``v [T, LM*D]`` bf16 -> ``[T, LM*D]`` f32:
  ``out[t, k] = sum_{i < reps} (x[t, k // D] + i) * f32(v[t, k])``, by the
  variants ``matmul`` (``(x + i) @ E``), ``jnp_repeat`` (``repeat_interleave``)
  and ``bcast3d`` (``x[..., None]`` against ``v`` viewed ``[T, LM, D]``);
- the tile, variant ``repeat``: ``out[t, k] = sum_i (x[t, k % LM] + i) *
  f32(v[t, k])``. The TPU body calls ``pltpu.repeat(x, D, axis=1)``, which
  tiles the row (``np.tile``), so this variant is not a broadcast; the port
  computes what the TPU body computes;
- reduce, ``x [T, LM*D]`` f32 -> ``[T, LM]`` f32: ``out[t, j] = sum_i sum_d
  (x[t, j*D + d] + i)``, by ``r_matmul`` (``(x + i) @ E^T``) and
  ``r_reshape_sum`` (a ``[T, LM, D]`` view summed over ``D``).

:func:`lane_broadcast` and :func:`lane_reduce` dispatch: a CPU tensor runs
the plain PyTorch version of the variant, a CUDA tensor launches the
hand-written kernel ``csrc/lane_broadcast.cu`` (one Hopper lowering per TPU
body, see there) or raises. Each counts its launches per variant in
``<wrapper>.launches`` (a ``Counter``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from mvdetr_tpu_torch.ops import kernel_build

KERNEL_NAME = "lane_broadcast"
L, M, D = 7, 8, 16  # the flagship's levels (cameras), heads, channels per head
LM = L * M
REPS = 81  # (2 * radius + 1)^2 shifts at radius 4
BROADCAST_VARIANTS = ("matmul", "repeat", "jnp_repeat", "bcast3d")
REDUCE_VARIANTS = ("r_matmul", "r_reshape_sum")
VARIANTS = BROADCAST_VARIANTS + REDUCE_VARIANTS
# the TPU body each variant replaces
TPU_BODIES = {"matmul": "scripts/exp_vpu_broadcast.py:81", "repeat": "scripts/exp_vpu_broadcast.py:89",
              "jnp_repeat": "scripts/exp_vpu_broadcast.py:96", "bcast3d": "scripts/exp_vpu_broadcast.py:103",
              "r_matmul": "scripts/exp_vpu_broadcast.py:125", "r_reshape_sum": "scripts/exp_vpu_broadcast.py:132"}
_VARIANT_CODE = {name: i for i, name in enumerate(VARIANTS)}


def select_matrix_e(m: int, l: int, d: int) -> np.ndarray:
    """E ``[L*M, L*M*D]`` f32: row ``l*M + m`` is 1 on the ``D`` columns of
    head ``m`` of level ``l``. Copy of the E half of
    ``mvdetr_tpu/ops/pallas/msda_kernel.py::_select_matrices``."""
    lm = l * m
    e = np.zeros((lm, lm * d), dtype=np.float32)
    for j in range(lm):
        e[j, j * d:(j + 1) * d] = 1.0
    return e


def lane_broadcast_plain(x: torch.Tensor, v: torch.Tensor, variant: str, reps: int = REPS) -> torch.Tensor:
    """Plain version of a broadcast variant (or the ``repeat`` tile), as the
    TPU body writes it: ``acc += f(x + i) * f32(v)`` for ``i`` in order."""
    t, lm = x.shape
    vf = v.float()
    e = torch.from_numpy(select_matrix_e(1, lm, D)).to(x.device) if variant == "matmul" else None
    acc = torch.zeros((t, lm, D) if variant == "bcast3d" else (t, lm * D), dtype=torch.float32, device=x.device)
    for i in range(reps):
        xi = x + float(i)
        if variant == "matmul":
            acc += (xi @ e) * vf
        elif variant == "repeat":
            acc += xi.repeat(1, D) * vf
        elif variant == "jnp_repeat":
            acc += xi.repeat_interleave(D, dim=1) * vf
        elif variant == "bcast3d":
            acc += xi[..., None] * vf.view(t, lm, D)
        else:
            raise ValueError(f"unknown broadcast variant {variant!r}; one of {BROADCAST_VARIANTS}")
    return acc.reshape(t, lm * D)


def lane_reduce_plain(x: torch.Tensor, variant: str, reps: int = REPS) -> torch.Tensor:
    """Plain version of a reduce variant: ``acc += sum_d (x + i)`` for ``i``
    in order, as ``(x + i) @ E^T`` or as a ``[T, LM, D]`` sum."""
    t, lk = x.shape
    lm = lk // D
    et = torch.from_numpy(select_matrix_e(1, lm, D).T.copy()).to(x.device) if variant == "r_matmul" else None
    acc = torch.zeros((t, lm), dtype=torch.float32, device=x.device)
    for i in range(reps):
        xi = x + float(i)
        if variant == "r_matmul":
            acc += xi @ et
        elif variant == "r_reshape_sum":
            acc += xi.view(t, lm, D).sum(-1)
        else:
            raise ValueError(f"unknown reduce variant {variant!r}; one of {REDUCE_VARIANTS}")
    return acc


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    lib = ctypes.CDLL(str(kernel_build.build(KERNEL_NAME)))
    lib.lane_broadcast_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.lane_broadcast_launch.restype = ctypes.c_int
    lib.lane_reduce_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.lane_reduce_launch.restype = ctypes.c_int
    lib.lane_broadcast_error_string.argtypes = [ctypes.c_int]
    lib.lane_broadcast_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, reps: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D f32 tensor, got {x.dtype} {tuple(x.shape)}")
    if not 0 <= reps < 2**24:  # i stays exact in f32
        raise ValueError(f"{name}: reps = {reps} out of range")


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.lane_broadcast_error_string(err).decode()} (cudaError {err})")


def lane_broadcast(x: torch.Tensor, v: torch.Tensor, variant: str, reps: int = REPS) -> torch.Tensor:
    """A broadcast variant (or the ``repeat`` tile): ``x [T, LM]`` f32 and
    ``v [T, LM*16]`` bf16 -> ``[T, LM*16]`` f32. On the CPU the plain version;
    on the card the kernel (``LM`` a multiple of 8, contiguous inputs), else
    it raises. Adds one to ``lane_broadcast.launches[variant]`` per launch."""
    if variant not in BROADCAST_VARIANTS:
        raise ValueError(f"unknown broadcast variant {variant!r}; one of {BROADCAST_VARIANTS}")
    if x.device.type == "cpu":
        return lane_broadcast_plain(x, v, variant, reps)
    _check("lane_broadcast", x, reps)
    t, lm = x.shape
    if lm % 8 or v.dtype != torch.bfloat16 or tuple(v.shape) != (t, lm * D) or not v.is_contiguous() \
            or v.device != x.device or v.data_ptr() % 4:
        raise ValueError(f"lane_broadcast: needs LM % 8 == 0 and a contiguous, 4-byte aligned bf16 v [T, LM*{D}] "
                         f"on {x.device}, got x {tuple(x.shape)}, v {v.dtype} {tuple(v.shape)} on {v.device}")
    out = torch.empty((t, lm * D), dtype=torch.float32, device=x.device)
    if t == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lane_broadcast_launch(x.data_ptr(), v.data_ptr(), out.data_ptr(), t, lm, int(reps),
                                        _VARIANT_CODE[variant], stream)
    _raise_on(lib, "lane_broadcast", err)
    lane_broadcast.launches[variant] += 1
    return out


lane_broadcast.launches = collections.Counter()


def lane_reduce(x: torch.Tensor, variant: str, reps: int = REPS) -> torch.Tensor:
    """A reduce variant: ``x [T, LM*16]`` f32 -> ``[T, LM]`` f32. On the CPU
    the plain version; on the card the kernel (``LM`` a multiple of 8,
    contiguous input), else it raises. Adds one to
    ``lane_reduce.launches[variant]`` per launch."""
    if variant not in REDUCE_VARIANTS:
        raise ValueError(f"unknown reduce variant {variant!r}; one of {REDUCE_VARIANTS}")
    if x.device.type == "cpu":
        return lane_reduce_plain(x, variant, reps)
    _check("lane_reduce", x, reps)
    t, lk = x.shape
    if lk % (8 * D):
        raise ValueError(f"lane_reduce: x must be [T, LM*{D}] with LM % 8 == 0, got {tuple(x.shape)}")
    out = torch.empty((t, lk // D), dtype=torch.float32, device=x.device)
    if t == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lane_reduce_launch(x.data_ptr(), out.data_ptr(), t, lk // D, int(reps), _VARIANT_CODE[variant],
                                     stream)
    _raise_on(lib, "lane_reduce", err)
    lane_reduce.launches[variant] += 1
    return out


lane_reduce.launches = collections.Counter()
