"""Perspective (homography) warp of NHWC feature maps, port of ``mvdetr_tpu/ops/warp.py``.

``mats`` map source pixels to destination pixels; each destination cell
samples the source at the inverse-mapped coordinate (bilinear, zero outside).
The JAX forward is a plain XLA gather with no Pallas kernel, so a plain torch
gather (:func:`~mvdetr_tpu_torch.ops.sampling.bilinear_patch_sample`) is its
counterpart here.

The backward (``_PatchSampleFn``, after ``_patch_sample_nocoordgrad``) is
:func:`warp_scatter_accumulate`: on a CUDA tensor the hand-written kernel
``csrc/warp_bwd.cu`` (:func:`warp_bwd`, replaces the TPU kernel
``mvdetr_tpu/ops/pallas/warp_bwd.py::_kernel``), on a CPU tensor the plain
:func:`~mvdetr_tpu_torch.ops.sampling.bilinear_scatter_matmul`. Without it,
autograd would differentiate ``index_select`` with ``index_add_``, a
float-atomic scatter on the card whose result changes from run to run. The
sampling coordinates get no gradient: they come from calibration and the
augmentation affine, never from parameters.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from mvdetr_tpu_torch.ops import kernel_build
from mvdetr_tpu_torch.ops.sampling import bilinear_patch_sample, bilinear_scatter_matmul

KERNEL_NAME = "warp_bwd"


def invert_3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det), ``m [..., 3, 3]``.

    The same arithmetic as the JAX function, so the bits match (an LU-based
    ``torch.linalg.inv`` would round differently).
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def warp_coords(mats: torch.Tensor, out_shape):
    """Source pixel coords sampled by each destination cell: two ``[B, Ho*Wo]`` tensors."""
    ho, wo = out_shape
    inv = invert_3x3(mats.to(torch.float32))  # dst -> src
    ys, xs = torch.meshgrid(
        torch.arange(ho, dtype=torch.float32, device=mats.device),
        torch.arange(wo, dtype=torch.float32, device=mats.device),
        indexing="ij",
    )
    dst = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)  # [Ho*Wo, 3]
    src = torch.einsum("bij,qj->bqi", inv, dst)
    eps = 1e-8
    z = src[..., 2]
    # keep the sign of a vanishing z (`warp.py:64-66`): points on the horizon
    # map far outside the source instead of to inf/nan
    z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)
    return src[..., 0] / z, src[..., 1] / z


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a build of ``csrc/warp_bwd.cu``."""
    lib.warp_bwd_temp_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]
    lib.warp_bwd_temp_bytes.restype = ctypes.c_int
    lib.warp_bwd_launch.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_size_t] + [ctypes.c_int] * 7
                                    + [ctypes.c_void_p])
    lib.warp_bwd_launch.restype = ctypes.c_int
    lib.warp_bwd_body.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                                  + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.warp_bwd_body.restype = ctypes.c_int
    lib.warp_bwd_error_string.argtypes = [ctypes.c_int]
    lib.warp_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the warp-backward kernel's shared library."""
    return bind(ctypes.CDLL(str(kernel_build.build(KERNEL_NAME))))


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_LIMIT = 2**31 - 1


def sort_end_bit(h: int, w: int) -> int:
    """Bits of B3's sort keys: a sample's base cell on the per-map ``(h+1) x
    (w+1)`` grid, ``0 .. (h+1)*(w+1) - 1``, and the sentinel ``(h+1)*(w+1)``
    of a sample whose four taps fall outside the map."""
    return max(1, ((int(h) + 1) * (int(w) + 1)).bit_length())


class Scratch(NamedTuple):
    """B3's buffers between its stages: keys and sample indices before and
    after the sort, the samples' fractions before and after it, the bins'
    segment starts, the sort's temporary storage."""

    keys: torch.Tensor  # [2, B*Q] int32 (unsigned in the kernel): unsorted, sorted
    order: torch.Tensor  # [2, B*Q] int32
    rec: torch.Tensor  # [2, B*Q, 2] f32: each sample's (wx1, wy1) in input order, then in sorted order
    start: torch.Tensor  # [B*(h+1)*(w+1) + 1] int32: a bin (base cell, map) is base * B + b
    temp: torch.Tensor  # uint8, the sort's temporary storage
    end_bit: int


def check_sizes(b: int, q: int, h: int, w: int) -> None:
    """Raise unless samples ``B*Q``, cells ``B*h*w`` and bins
    ``B*(h+1)*(w+1)`` (with the sentinel's) fit the kernel's int32 indices
    and ``h, w < 2^24`` its f32 grid coordinates."""
    bins = b * (h + 1) * (w + 1)
    if b * q >= _INT32_LIMIT or b * h * w >= _INT32_LIMIT or bins >= _INT32_LIMIT:
        raise ValueError(f"warp_bwd: B*Q = {b * q}, B*h*w = {b * h * w} and B*(h+1)*(w+1) = {bins} must be below "
                         "2^31 - 1, the kernel's int32 indices")
    if h >= 2**24 or w >= 2**24:
        raise ValueError(f"warp_bwd: h = {h} and w = {w} must be below 2^24, exact in f32")


@functools.lru_cache(maxsize=64)
def _temp_bytes(lib: ctypes.CDLL, n: int, end_bit: int, device: torch.device) -> int:
    nbytes = ctypes.c_size_t(0)
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        _raise_on(lib, lib.warp_bwd_temp_bytes(n, end_bit, ctypes.byref(nbytes)))
    return nbytes.value


def alloc_scratch(lib: ctypes.CDLL, b: int, q: int, h: int, w: int, device) -> Scratch:
    """Scratch for ``lib``'s B3 on ``B`` views of ``Q`` samples onto
    ``h x w``; the sort's temporary bytes come from ``warp_bwd_temp_bytes``."""
    check_sizes(b, q, h, w)
    n, end_bit = b * q, sort_end_bit(h, w)
    device = torch.device(device)
    return Scratch(keys=torch.empty((2, n), dtype=torch.int32, device=device),
                   order=torch.empty((2, n), dtype=torch.int32, device=device),
                   rec=torch.empty((2, n, 2), dtype=torch.float32, device=device),
                   start=torch.empty(b * (h + 1) * (w + 1) + 1, dtype=torch.int32, device=device),
                   temp=torch.empty(_temp_bytes(lib, n, end_bit, device), dtype=torch.uint8, device=device),
                   end_bit=end_bit)


def launch(lib: ctypes.CDLL, g, sx, sy, out, scratch: Scratch) -> None:
    """Run ``lib``'s B3 on checked inputs into ``out [B, h, w, C]``, on the
    current stream of ``g``'s device; raises on a CUDA error."""
    b, q, c = g.shape
    _, h, w, _ = out.shape
    s = scratch
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        _raise_on(lib, lib.warp_bwd_launch(
            g.data_ptr(), sx.data_ptr(), sy.data_ptr(), out.data_ptr(), s.keys[0].data_ptr(), s.keys[1].data_ptr(),
            s.order[0].data_ptr(), s.order[1].data_ptr(), s.rec.data_ptr(), s.start.data_ptr(), s.temp.data_ptr(),
            s.temp.numel(), b, q, h, w, c, _DTYPE_CODES[g.dtype], s.end_bit, stream))


def body(g: torch.Tensor, out: torch.Tensor) -> tuple:
    """The walk's body that B3's C entry picks for ``g`` and ``out`` (on the
    card): ``(lanes a cell, channels a lane)``."""
    lib = load_library()
    lanes, vec = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(lib, lib.warp_bwd_body(g.shape[-1], _DTYPE_CODES[g.dtype], g.data_ptr(), out.data_ptr(),
                                     ctypes.byref(lanes), ctypes.byref(vec)))
    return lanes.value, vec.value


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = lib.warp_bwd_error_string(err).decode()
        raise RuntimeError(f"warp_bwd launch failed: {msg} (cudaError {err})")


def warp_bwd(g: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Launch the B3 kernel: ``g [B, Q, C]`` (f32 or bf16) and f32
    coordinates ``sx/sy [B, Q]``, contiguous on one CUDA device ->
    ``grad [B, h, w, C]`` in ``g.dtype``.

    The kernel's stages key each sample by its base cell, sort the keys
    (index plumbing), find each (base cell, map) segment and the samples'
    weights, and sum each cell's taps in query order, merging the four
    base cells it draws from. Raises on any input the kernel does not take; never
    computes on another path. Adds one to ``warp_bwd.launches`` per launch."""
    if g.device.type != "cuda":
        raise ValueError(f"warp_bwd runs on a CUDA device only, got g on {g.device}")
    if g.dtype not in _DTYPE_CODES:
        raise ValueError(f"warp_bwd takes f32 or bf16 cotangents, got {g.dtype}")
    if g.dim() != 3 or tuple(sx.shape) != tuple(g.shape[:2]) or tuple(sy.shape) != tuple(g.shape[:2]):
        raise ValueError(f"warp_bwd: g {tuple(g.shape)} must be [B, Q, C] and sx/sy [B, Q], got "
                         f"{tuple(sx.shape)}, {tuple(sy.shape)}")
    for name, t in (("sx", sx), ("sy", sy)):
        if t.device != g.device or t.dtype != torch.float32:
            raise ValueError(f"warp_bwd: {name} must be f32 on {g.device}, got {t.dtype} on {t.device}")
    if not (g.is_contiguous() and sx.is_contiguous() and sy.is_contiguous()):
        raise ValueError("warp_bwd: inputs must be contiguous")
    b, q, c = g.shape
    out = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    launch(lib, g, sx, sy, out, alloc_scratch(lib, b, q, h, w, g.device))
    warp_bwd.launches += 1
    return out


warp_bwd.launches = 0


def warp_scatter_accumulate(g: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Adjoint-of-sampling dispatch (`mvdetr_tpu/ops/warp.py:93-117`): a CUDA
    tensor goes to the B3 kernel, a CPU tensor to the plain version, with no
    fallback between them."""
    if g.device.type == "cuda":
        return warp_bwd(g.contiguous(), sx.to(torch.float32).contiguous(), sy.to(torch.float32).contiguous(), h, w)
    if g.device.type == "cpu":
        return bilinear_scatter_matmul(g, sx, sy, h, w)
    raise ValueError(f"warp_scatter_accumulate: unsupported device {g.device}")


class _PatchSampleFn(torch.autograd.Function):
    """:func:`bilinear_patch_sample` whose backward is
    :func:`warp_scatter_accumulate` (`mvdetr_tpu/ops/warp.py:70-90`); the
    coordinates get no gradient."""

    @staticmethod
    def forward(ctx, feats, sx, sy):
        ctx.hw = feats.shape[1:3]
        ctx.save_for_backward(sx, sy)
        return bilinear_patch_sample(feats, sx, sy)

    @staticmethod
    def backward(ctx, g):
        sx, sy = ctx.saved_tensors
        return warp_scatter_accumulate(g, sx, sy, *ctx.hw), None, None


def perspective_warp(feats: torch.Tensor, mats: torch.Tensor, out_shape) -> torch.Tensor:
    """Warp ``feats [B, H, W, C]`` by per-sample homographies ``mats [B, 3, 3]``
    to ``[B, Ho, Wo, C]``, zeros outside the source support. Differentiable
    with respect to ``feats`` (deterministic backward, B3 on the card);
    ``mats`` get no gradient."""
    ho, wo = out_shape
    b, _, _, c = feats.shape
    sx, sy = warp_coords(mats.detach(), out_shape)
    return _PatchSampleFn.apply(feats, sx, sy).reshape(b, ho, wo, c)
