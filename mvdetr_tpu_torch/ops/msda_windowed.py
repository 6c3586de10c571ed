"""Windowed deformable attention, port of ``mvdetr_tpu/ops/msda_windowed.py``.

In the flagship configuration (``n_points=4``) the reference map is the
identity grid, so each sample sits at its query's BEV cell plus a learned
offset, clamped to ``+-radius`` cells. The pieces:

- :func:`ms_deform_attn_windowed`, the plain PyTorch forward: a 4-tap
  bilinear gather at the clamped offset, zero outside the grid, summed in
  f32. The CPU path and the tests use it.
- :func:`ms_deform_attn_windowed_bwd`, the plain backward, written out by
  hand with the TPU kernel's gradient convention (see below).
- :func:`msda_windowed_fwd` and :func:`msda_windowed_bwd`, the wrappers of
  the hand-written CUDA kernels ``csrc/msda_windowed_fwd.cu`` (B1, replaces
  ``mvdetr_tpu/ops/pallas/msda_kernel.py::_kernel``) and
  ``csrc/msda_windowed_bwd.cu`` (B2, replaces
  ``mvdetr_tpu/ops/pallas/msda_kernel_bwd.py::_bwd_kernel``). Each counts its
  launches in ``<wrapper>.launches``.
- :func:`windowed_attention`, the dispatch through ``_WindowedAttentionFn``:
  a CPU tensor runs the plain forward and backward, a CUDA tensor the
  kernels, with no fallback between them.

Gradient convention. The TPU kernel's hat derivative is ``-sign(t)`` for
``|t| < 1`` and 0 otherwise (`msda_kernel_bwd.py:88,98`), so an offset that is
an exact integer gets a zero cotangent. Autodiff of the JAX XLA op gives a
central difference there, and autograd of the 4-tap plain forward would give
a one-sided one; the three agree at non-integer offsets. The port follows the
TPU kernel on both devices, which is why the plain backward is written out
and the CPU path goes through ``_WindowedAttentionFn`` too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mvdetr_tpu_torch.ops import kernel_build

KERNEL_NAME = "msda_windowed_fwd"
BWD_KERNEL_NAME = "msda_windowed_bwd"


def ms_deform_attn_windowed(
    value: torch.Tensor,  # [B, L, H, W, M, D]
    offsets: torch.Tensor,  # [B, C, H, W, M, L, P, 2] raw offsets in cells (x, y)
    weights: torch.Tensor,  # [B, C, H, W, M, L, P]
    radius: int = 4,
    flatten: bool = True,
) -> torch.Tensor:
    """Plain version: ``[B, C*H*W, M*D]`` f32 (``[B, C, H, W, M*D]`` when
    ``flatten=False``).

    The JAX function sums (2R+1)^2 shifted windows with hat weights; for an
    offset clamped to ``+-radius`` that sum is exactly the bilinear gather
    written here. It loops over the L*P samples so that it holds one
    ``[B, C, H, W, M, D]`` gather at a time, and uses the kernel's
    arithmetic: the fraction comes from the clamped offset itself, and the
    taps are blended as ``(1-fy)*((1-fx)*v00 + fx*v01) + fy*(...)``.
    """
    b, l, h, w, m, d = value.shape
    c, p = offsets.shape[1], offsets.shape[6]
    dev = value.device
    r = float(radius)
    # rows ordered (b, l, m, y, x) so one flat index addresses a tap
    v = value.float().permute(0, 1, 4, 2, 3, 5).reshape(b * l * m * h * w, d)
    off = offsets.float()
    wgt = weights.float()
    xs = torch.arange(w, device=dev).view(1, 1, 1, w, 1)
    ys = torch.arange(h, device=dev).view(1, 1, h, 1, 1)
    bm = (torch.arange(b, device=dev).view(b, 1, 1, 1, 1) * l * m
          + torch.arange(m, device=dev).view(1, 1, 1, 1, m))  # (b*L + 0)*M + m
    acc = torch.zeros((b, c, h, w, m, d), dtype=torch.float32, device=dev)
    for li in range(l):
        for pi in range(p):
            ox = off[:, :, :, :, :, li, pi, 0].clamp(-r, r)
            oy = off[:, :, :, :, :, li, pi, 1].clamp(-r, r)
            ix = torch.floor(ox)
            iy = torch.floor(oy)
            fx = (ox - ix)[..., None]
            fy = (oy - iy)[..., None]
            x0 = xs + ix.long()
            y0 = ys + iy.long()
            taps = []
            for dy in (0, 1):
                for dx in (0, 1):
                    yy, xx = y0 + dy, x0 + dx
                    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                    row = ((bm + li * m) * h + yy.clamp(0, h - 1)) * w + xx.clamp(0, w - 1)
                    tap = v.index_select(0, row.reshape(-1)).view(b, c, h, w, m, d)
                    taps.append(tap * ok[..., None])
            top = (1.0 - fx) * taps[0] + fx * taps[1]
            bot = (1.0 - fx) * taps[2] + fx * taps[3]
            acc += wgt[:, :, :, :, :, li, pi, None] * ((1.0 - fy) * top + fy * bot)
    out = acc.reshape(b, c, h, w, m * d)
    return out.reshape(b, c * h * w, m * d) if flatten else out


def _hat_slope(t: torch.Tensor) -> torch.Tensor:
    """Slope of the hat weight ``max(0, 1 - |t|)`` as the TPU kernel takes it
    (`msda_kernel_bwd.py:88,98`): ``-sign(t)`` for ``|t| < 1``, else 0."""
    return torch.where(t.abs() < 1.0, -torch.sign(t), torch.zeros_like(t))


def ms_deform_attn_windowed_bwd(
    value: torch.Tensor,  # [B, L, H, W, M, D]
    offsets: torch.Tensor,  # [B, C, H, W, M, L, P, 2] raw offsets
    weights: torch.Tensor,  # [B, C, H, W, M, L, P]
    g: torch.Tensor,  # [B, C, H, W, M*D] (or [B, C*H*W, M*D]) cotangent of the forward
    radius: int = 4,
):
    """Plain backward: ``(g_value, g_offsets, g_weights)`` in f32, shaped as
    the inputs.

    Per query, head and sample, with ``fx, fy`` taken from the clamped offset
    as the forward does:

    - ``g_w = sum_d g * bilinear(v)``;
    - ``g_ox = w [|ox_raw| <= R] sum_d g ((1-fy)(sa v00 + sb v01) + fy(sa v10 + sb v11))``
      with the TPU kernel's hat slopes ``sa = slope(ox - ix)``,
      ``sb = slope(ox - ix - 1)``, ``slope(t) = -sign(t)`` for ``|t| < 1``
      else 0, ``t`` computed in f32 (:func:`_hat_slope`). For a fraction
      ``fx`` in (0, 1) that is ``v01 - v00``; at an integer offset both
      slopes are 0; for ``fx`` below f32 resolution next to 1 only one tap
      keeps its slope, as on the TPU. ``g_oy`` likewise with the axes
      swapped;
    - each tap's value cell gets ``(w * cy) * cx * g``, summed with
      ``index_add_`` (deterministic on the CPU).
    """
    b, l, h, w, m, d = value.shape
    c, p = offsets.shape[1], offsets.shape[6]
    dev = value.device
    r = float(radius)
    v = value.float().permute(0, 1, 4, 2, 3, 5).reshape(b * l * m * h * w, d)
    gq = g.float().reshape(b, c, h, w, m, d)
    off = offsets.float()
    wgt = weights.float()
    xs = torch.arange(w, device=dev).view(1, 1, 1, w, 1)
    ys = torch.arange(h, device=dev).view(1, 1, h, 1, 1)
    bm = (torch.arange(b, device=dev).view(b, 1, 1, 1, 1) * l * m
          + torch.arange(m, device=dev).view(1, 1, 1, 1, m))
    g_value = torch.zeros((b * l * m * h * w, d), dtype=torch.float32, device=dev)
    g_off = torch.zeros(off.shape, dtype=torch.float32, device=dev)
    g_wgt = torch.zeros(wgt.shape, dtype=torch.float32, device=dev)
    for li in range(l):
        for pi in range(p):
            ox_raw = off[:, :, :, :, :, li, pi, 0]
            oy_raw = off[:, :, :, :, :, li, pi, 1]
            ox = ox_raw.clamp(-r, r)
            oy = oy_raw.clamp(-r, r)
            ix = torch.floor(ox)
            iy = torch.floor(oy)
            fx = ox - ix
            fy = oy - iy
            x0 = xs + ix.long()
            y0 = ys + iy.long()
            wl = wgt[:, :, :, :, :, li, pi]
            taps, rows, corners = [], [], []
            for dy in (0, 1):
                for dx in (0, 1):
                    yy, xx = y0 + dy, x0 + dx
                    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                    row = ((bm + li * m) * h + yy.clamp(0, h - 1)) * w + xx.clamp(0, w - 1)
                    tap = v.index_select(0, row.reshape(-1)).view(b, c, h, w, m, d) * ok[..., None]
                    taps.append(tap)
                    rows.append(row)
                    cy = fy if dy else 1.0 - fy
                    cx = fx if dx else 1.0 - fx
                    corners.append((wl * cy) * cx * ok)
            t00, t01, t10, t11 = taps
            fx_, fy_ = fx[..., None], fy[..., None]
            top = (1.0 - fx_) * t00 + fx_ * t01
            bot = (1.0 - fx_) * t10 + fx_ * t11
            g_wgt[:, :, :, :, :, li, pi] = (gq * ((1.0 - fy_) * top + fy_ * bot)).sum(-1)
            sax, sbx = _hat_slope(ox - ix)[..., None], _hat_slope(ox - (ix + 1.0))[..., None]
            say, sby = _hat_slope(oy - iy)[..., None], _hat_slope(oy - (iy + 1.0))[..., None]
            sx = (gq * ((1.0 - fy_) * (sax * t00 + sbx * t01) + fy_ * (sax * t10 + sbx * t11))).sum(-1)
            sy = (gq * ((1.0 - fx_) * (say * t00 + sby * t10) + fx_ * (say * t01 + sby * t11))).sum(-1)
            g_off[:, :, :, :, :, li, pi, 0] = torch.where(ox_raw.abs() <= r, wl * sx, 0.0)
            g_off[:, :, :, :, :, li, pi, 1] = torch.where(oy_raw.abs() <= r, wl * sy, 0.0)
            for row, coef in zip(rows, corners):
                g_value.index_add_(0, row.reshape(-1), (coef[..., None] * gq).reshape(-1, d))
    g_value = g_value.view(b, l, m, h, w, d).permute(0, 1, 3, 4, 2, 5).contiguous()
    return g_value, g_off, g_wgt


class FwdPlan(NamedTuple):
    """How B1 tiles one launch: ``vec`` channels per thread (one load of
    ``2 * vec`` bytes per tap), ``tile_y x tile_x`` queries of one head per
    block, ``threads`` per block."""

    vec: int
    tile_y: int
    tile_x: int
    threads: int


def _check_sizes(name: str, m: int, d: int, radius) -> None:
    """The sizes B1 and B2 take: ``0 < M*D <= 1024`` and an integer radius
    ``>= 0``."""
    if not 0 < m * d <= 1024:
        raise ValueError(f"{name}: M*D = {m * d} must be in [1, 1024]")
    if int(radius) != radius or radius < 0:
        raise ValueError(f"{name}: radius must be a non-negative integer, got {radius}")


def _fwd_plan(w: int, m: int, d: int, p: int, radius: int, value_align: int = 16) -> FwdPlan:
    """B1's tiling for a grid ``w`` cells wide, head width ``d`` (``m``
    heads), ``p`` points and ``radius``, with the value's data pointer
    aligned to ``value_align`` bytes; raises ``ValueError`` on what the
    kernel cannot take. The only planning rule: the wrapper passes its
    result to the launcher, which checks it again.

    The widest ``vec`` of 8, 4, 2, 1 that divides ``d`` and the alignment,
    and a tile 16 queries wide of about 128 threads, or 256 from R=8 on,
    where the taps of a larger tile share more L1 lines (PERF.md, B1).
    Every tile gives the same bits. The kernels address a tap by a 32-bit
    offset from the query's own cell (B2's query side in bytes), so
    ``2 * (R + 1) * (W + 1) * M * D < 2^31``."""
    _check_sizes("msda_windowed_fwd", m, d, radius)
    if p < 0:
        raise ValueError(f"msda_windowed_fwd: P = {p} must be non-negative")
    if 2 * (radius + 1) * (w + 1) * m * d >= 2**31:
        raise ValueError(f"msda_windowed_fwd: radius {radius} on a grid {w} wide with M*D = {m * d} reaches taps "
                         f"beyond a 32-bit offset")
    vec = next(v for v in (8, 4, 2, 1) if d % v == 0 and value_align % (2 * v) == 0)
    nchunk = d // vec  # <= 256 for vec >= 4, <= 1024 else: one query always fits the kernel's block
    q = max(1, (256 if radius >= 8 else 128) // nchunk)
    tile_x = min(16, q)
    tile_y = q // tile_x
    return FwdPlan(vec, tile_y, tile_x, tile_y * tile_x * nchunk)


def _query_plan(value: torch.Tensor, g: torch.Tensor, p: int, radius: int) -> FwdPlan:
    """The plan of B2's query side, whose taps are B1's taps: :func:`_fwd_plan`
    at the alignment that both the value's taps and ``g``'s loads allow (``vec``
    f32 channels of g take twice the bytes of ``vec`` bf16 taps)."""
    _, _, _, w, m, d = value.shape
    return _fwd_plan(w, m, d, p, radius, value_align=min(_value_align(value), _value_align(g) // 2))


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    lib = ctypes.CDLL(str(kernel_build.build(KERNEL_NAME)))
    lib.msda_windowed_fwd_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.msda_windowed_fwd_launch.restype = ctypes.c_int
    lib.msda_windowed_fwd_error_string.argtypes = [ctypes.c_int]
    lib.msda_windowed_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(name: str, value, offsets, weights, radius):
    """Device, type, shape and contiguity checks shared by B1 and B2; returns
    ``(b, c, l, h, w, m, d, p)``."""
    if value.device.type != "cuda":
        raise ValueError(f"{name} runs on a CUDA device only, got value on {value.device}")
    for what, t in (("offsets", offsets), ("weights", weights)):
        if t.device != value.device:
            raise ValueError(f"{name}: {what} on {t.device}, value on {value.device}")
    if value.dtype != torch.bfloat16 or offsets.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError(f"{name} takes a bf16 value and f32 offsets and weights, got "
                         f"{value.dtype}, {offsets.dtype}, {weights.dtype}")
    if value.dim() != 6 or offsets.dim() != 8 or weights.dim() != 7:
        raise ValueError(f"{name}: value must be 6-D, offsets 8-D and weights 7-D")
    b, l, h, w, m, d = value.shape
    c, p = offsets.shape[1], offsets.shape[6]
    if tuple(offsets.shape) != (b, c, h, w, m, l, p, 2) or tuple(weights.shape) != (b, c, h, w, m, l, p):
        raise ValueError(f"{name}: shapes do not fit value {tuple(value.shape)}: offsets "
                         f"{tuple(offsets.shape)}, weights {tuple(weights.shape)}")
    if not (value.is_contiguous() and offsets.is_contiguous() and weights.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    return b, c, l, h, w, m, d, p


def _value_align(value: torch.Tensor) -> int:
    """The largest power of two that divides ``value``'s data pointer (0 for
    a null pointer), as B1's plan takes it."""
    return value.data_ptr() & -value.data_ptr()


def msda_windowed_fwd(value: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor,
                      radius: int) -> torch.Tensor:
    """Launch the B1 kernel: ``value [B, L, H, W, M, D]`` bf16, raw
    ``offsets [B, C, H, W, M, L, P, 2]`` f32 and ``weights [B, C, H, W, M, L, P]``
    f32, all contiguous on one CUDA device -> ``[B, C, H, W, M*D]`` f32,
    tiled by :func:`_fwd_plan`.

    Raises on any input the kernel does not take; never computes on another
    path. Adds one to ``msda_windowed_fwd.launches`` per launch."""
    b, c, l, h, w, m, d, p = _check_kernel_inputs("msda_windowed_fwd", value, offsets, weights, radius)
    plan = _fwd_plan(w, m, d, p, int(radius), value_align=_value_align(value))
    out = torch.empty((b, c, h, w, m * d), dtype=torch.float32, device=value.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.msda_windowed_fwd_launch(
            value.data_ptr(), offsets.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, c, l, h, w, m, d, p, int(radius), plan.vec, plan.tile_y, plan.tile_x, stream,
        )
    if err != 0:
        msg = lib.msda_windowed_fwd_error_string(err).decode()
        raise RuntimeError(f"msda_windowed_fwd launch failed: {msg} (cudaError {err})")
    msda_windowed_fwd.launches += 1
    return out


msda_windowed_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def load_bwd_library() -> ctypes.CDLL:
    """Build (at first use) and load the backward kernel's shared library."""
    lib = ctypes.CDLL(str(kernel_build.build(BWD_KERNEL_NAME)))
    lib.msda_windowed_bwd_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.msda_windowed_bwd_launch.restype = ctypes.c_int
    lib.msda_windowed_bwd_sides_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    lib.msda_windowed_bwd_sides_launch.restype = ctypes.c_int
    lib.msda_windowed_bwd_error_string.argtypes = [ctypes.c_int]
    lib.msda_windowed_bwd_error_string.restype = ctypes.c_char_p
    return lib


_BWD_SIDES = {"query": 1, "value": 2, "both": 3}


def msda_windowed_bwd(value: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor, g: torch.Tensor,
                      radius: int, side: str = "both"):
    """Launch the B2 kernel on the forward's staged inputs (bf16 value, f32
    raw offsets and weights) and the f32 cotangent ``g [B, C, H, W, M*D]``,
    all contiguous on one CUDA device -> f32 ``(g_value, g_offsets,
    g_weights)`` shaped as the inputs. The query side (``g_offsets``,
    ``g_weights``) is tiled by :func:`_query_plan`.

    ``side`` ``"value"`` or ``"query"`` runs only the kernel of ``g_value`` or
    of ``(g_offsets, g_weights)`` (to time each); the other outputs are then
    left uninitialised. Raises on any input the kernel does not take; never
    computes on another path. Adds one to ``msda_windowed_bwd.launches`` per
    launch."""
    if side not in _BWD_SIDES:
        raise ValueError(f"msda_windowed_bwd: side must be one of {sorted(_BWD_SIDES)}, got {side!r}")
    b, c, l, h, w, m, d, p = _check_kernel_inputs("msda_windowed_bwd", value, offsets, weights, radius)
    _check_sizes("msda_windowed_bwd", m, d, radius)
    if g.device != value.device or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"msda_windowed_bwd: g must be contiguous f32 on {value.device}, got {g.dtype} on {g.device}")
    if g.numel() != b * c * h * w * m * d:
        raise ValueError(f"msda_windowed_bwd: g {tuple(g.shape)} does not fit [B, C, H, W, M*D] = "
                         f"{(b, c, h, w, m * d)}")
    if offsets.data_ptr() % 8:
        raise ValueError("msda_windowed_bwd: offsets must be 8-byte aligned (the kernel reads (x, y) pairs)")
    plan = _query_plan(value, g, p, int(radius))
    g_value = torch.empty(value.shape, dtype=torch.float32, device=value.device)
    g_off = torch.empty(offsets.shape, dtype=torch.float32, device=value.device)
    g_wgt = torch.empty(weights.shape, dtype=torch.float32, device=value.device)
    if g_value.numel() == 0 and g_wgt.numel() == 0:
        return g_value, g_off, g_wgt
    lib = load_bwd_library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.msda_windowed_bwd_sides_launch(
            value.data_ptr(), offsets.data_ptr(), weights.data_ptr(), g.data_ptr(),
            g_value.data_ptr(), g_off.data_ptr(), g_wgt.data_ptr(),
            b, c, l, h, w, m, d, p, int(radius), plan.vec, plan.tile_y, plan.tile_x, _BWD_SIDES[side], stream,
        )
    if err != 0:
        msg = lib.msda_windowed_bwd_error_string(err).decode()
        raise RuntimeError(f"msda_windowed_bwd launch failed: {msg} (cudaError {err})")
    msda_windowed_bwd.launches += 1
    return g_value, g_off, g_wgt


msda_windowed_bwd.launches = 0


class _WindowedAttentionFn(torch.autograd.Function):
    """Windowed attention behind autograd, on either device.

    On the card the forward stages the inputs as the TPU path stages them
    (value cast to bf16, offsets and weights to f32), launches B1 and keeps
    the staged tensors; the backward launches B2 on them. On the CPU the
    forward is the plain version on the inputs as given and the backward the
    plain backward. Cotangents return in the inputs' own dtypes.
    """

    @staticmethod
    def forward(ctx, value, offsets, weights, radius):
        ctx.radius = radius
        ctx.dtypes = (value.dtype, offsets.dtype, weights.dtype)
        if value.device.type == "cuda":
            value = value.to(torch.bfloat16).contiguous()
            offsets = offsets.to(torch.float32).contiguous()
            weights = weights.to(torch.float32).contiguous()
            out = msda_windowed_fwd(value, offsets, weights, radius)
        else:
            out = ms_deform_attn_windowed(value, offsets, weights, radius, flatten=False)
        ctx.save_for_backward(value, offsets, weights)
        return out

    @staticmethod
    def backward(ctx, grad):
        value, offsets, weights = ctx.saved_tensors
        if value.device.type == "cuda":
            grads = msda_windowed_bwd(value, offsets, weights, grad.to(torch.float32).contiguous(), ctx.radius)
        else:
            grads = ms_deform_attn_windowed_bwd(value, offsets, weights, grad, ctx.radius)
        return (*(gr.to(dt) for gr, dt in zip(grads, ctx.dtypes)), None)


def windowed_attention(value, offsets, weights, radius: int = 4, row_halo: bool = False,
                       flatten: bool = True) -> torch.Tensor:
    """Windowed deformable attention with device dispatch; the same contract
    as :func:`ms_deform_attn_windowed`, differentiable in all three inputs.

    A CUDA tensor runs the kernels (B1 forward, B2 backward) on the inputs
    staged as the TPU path stages them; a CPU tensor runs the plain forward
    and backward on the inputs as given.
    """
    if row_halo:
        raise NotImplementedError("row_halo (BEV-row sharding) waits for the multi-GPU slice (ROADMAP A9)")
    if value.device.type not in ("cuda", "cpu"):
        raise ValueError(f"windowed_attention: unsupported device {value.device}")
    out = _WindowedAttentionFn.apply(value, offsets, weights, radius)
    b, c, h, w, k = out.shape
    return out.reshape(b, c * h * w, k) if flatten else out
