"""Multi-scale deformable attention in ``gather`` mode, port of
``mvdetr_tpu/ops/msda.py``.

Contract (the JAX module's docstring)::

    value           [B, S, M, D]        S = sum_l H_l * W_l, level-major
    sampling_loc    [B, Q, M, L, P, 2]  per-level coords in [0, 1], f32
    attn_weight     [B, Q, M, L, P]     softmaxed over (L, P), value dtype
    out[b,q,m,:] = sum_{l,p} w * bilinear(value_l, x = loc_x*W_l - 0.5, y = loc_y*H_l - 0.5)
    -> [B, Q, M*D]

with every corner outside its level masked on its own. JAX runs this as a
plain XLA gather with no Pallas kernel. Here the plain torch gather
(:func:`ms_deform_attn_same_shape`, :func:`gather_fwd_plain`) is the CPU
path and the oracle of the hand-written kernels ``csrc/msda_gather.cu``
(:func:`msda_gather_fwd`, :func:`msda_gather_bwd`), which a CUDA tensor
launches, or raises: nothing falls back between them.

The backward is :class:`_GatherAttnFn`'s, with no scatter at all: autograd
through ``index_select`` would accumulate the value's gradient with
``index_add_``, a float-atomic scatter on the card whose result changes from
run to run. The value's gradient is the adjoint of bilinear sampling with
each sample's cotangent scaled by its attention weight, which is the function
of the warp backward (TPU kernel B3): on a CUDA tensor
:func:`mvdetr_tpu_torch.ops.warp.warp_scatter_accumulate` launches
``csrc/warp_bwd.cu``, on a CPU tensor it runs the plain
:func:`~mvdetr_tpu_torch.ops.sampling.bilinear_scatter_matmul`. The
locations' and weights' gradients are gathers and products, as JAX's
autodiff forms them (``floor`` has zero gradient, so the slope comes through
``x - floor(x)`` alone). :func:`msda_gather_bwd` forms them, and B3's
inputs, in one pass over the samples; :func:`gather_bwd_plain` is its plain
version.

The pixel coordinates are XLA's on the CPU, bit for bit: XLA contracts
``loc * W - 0.5`` into one fused multiply-add, rounded once, and so does
:func:`fma` (the models' ``ref + offsets / [W, H]`` likewise, see
``models/deformable.py``). Where an offset is an integer, as the radial init
makes most of them, ``x`` lies within an ulp of an integer and a second
rounding would move ``floor(x)`` to the next cell: the forward is continuous
there, but the offsets' gradient is not.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mvdetr_tpu_torch.ops import kernel_build
from mvdetr_tpu_torch.ops.sampling import bilinear_gather
from mvdetr_tpu_torch.ops.warp import warp_scatter_accumulate

KERNEL_NAME = "msda_gather"
MAX_HEAD_DIM = 1024  # csrc/msda_gather.cu: 8 channels a chunk, 32 lanes a (query, head), 4 chunks a lane
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` for f32 ``a`` (and ``b``, ``c``), rounded to f32 once,
    as a fused multiply-add rounds it: the product of two f32 values is exact
    in f64, and so is its sum with ``c`` wherever this module forms one (a
    sum that does round in f64 lands on an f32 tie, a second rounding, only
    in cases of probability ~2^-29)."""
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    c = c.double() if isinstance(c, torch.Tensor) else float(c)
    return (a.double() * b + c).float()


def level_start_indices(spatial_shapes) -> tuple:
    """Prefix offsets of each level in the flattened S axis."""
    starts, acc = [], 0
    for h, w in spatial_shapes:
        starts.append(acc)
        acc += int(h) * int(w)
    return tuple(starts)


def _contract(w: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """``sum_k w[..., k] * taps[..., k, :]`` in the taps' dtype: the products
    of bf16 inputs are exact in the f32 accumulator, and the result is
    rounded once, as XLA contracts ``einsum``."""
    return torch.matmul(w.unsqueeze(-2), taps).squeeze(-2)


def ms_deform_attn(value: torch.Tensor, spatial_shapes, sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain version with one gather per level (levels of any shape): the
    oracle of :func:`ms_deform_attn_same_shape`. Returns ``[B, Q, M*D]``."""
    b, s, m, d = value.shape
    _, q, m2, l, p, _ = sampling_locations.shape
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if m != m2 or l != len(shapes) or sum(h * w for h, w in shapes) != s:
        raise ValueError(f"ms_deform_attn: value {tuple(value.shape)} and locations "
                         f"{tuple(sampling_locations.shape)} do not fit the levels {shapes}")
    starts = level_start_indices(shapes)
    loc = sampling_locations.movedim(2, 1)  # [B, M, Q, L, P, 2]
    wgt = attention_weights.movedim(2, 1)  # [B, M, Q, L, P]
    out = torch.zeros((b, m, q, d), dtype=value.dtype, device=value.device)
    for lid, (h, w) in enumerate(shapes):
        v_l = value[:, starts[lid]:starts[lid] + h * w].movedim(2, 1).reshape(b * m, h * w, d)
        x = fma(loc[:, :, :, lid, :, 0], w, -0.5).reshape(b * m, q * p)
        y = fma(loc[:, :, :, lid, :, 1], h, -0.5).reshape(b * m, q * p)
        taps = bilinear_gather(v_l, x, y, h, w).reshape(b, m, q, p, d)
        out = out + _contract(wgt[:, :, :, lid, :], taps)
    return out.movedim(1, 2).reshape(b, q, m * d)


def _corners(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """The bilinear corners of pixel coords ``x/y [BM, Q, L, P]`` on ``L``
    levels of ``h x w``: the row of each sample's 2x2 patch in
    :func:`_patch_rows` (``[BM, Q, L, P]``), and per corner, in JAX's order
    (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1), ``(inb, wy, wx, sign of
    d/dy, sign of d/dx)``.

    A patch starts at the padded cell ``(y0+1, x0+1)``, clamped to the
    padded map: wherever a corner lies inside the map nothing is clamped, so
    its tap is the value JAX's clamped per-corner index reads; a corner
    outside reads zero padding or a clamped patch, as JAX reads a clamped
    cell, and either is multiplied by its zero weight."""
    bm, _, l, _ = x.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    maps = (torch.arange(bm, device=x.device).view(bm, 1, 1, 1) * l
            + torch.arange(l, device=x.device).view(1, 1, l, 1))
    rows = ((maps * (h + 1) + torch.clamp(y0 + 1.0, 0, h).to(torch.int64)) * (w + 1)
            + torch.clamp(x0 + 1.0, 0, w).to(torch.int64))
    corners = []
    for yc, xc, wyc, wxc, sy, sx in ((y0, x0, wy0, wx0, -1.0, -1.0), (y0, x0 + 1.0, wy0, wx1, -1.0, 1.0),
                                     (y0 + 1.0, x0, wy1, wx0, 1.0, -1.0),
                                     (y0 + 1.0, x0 + 1.0, wy1, wx1, 1.0, 1.0)):
        inb = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        corners.append((inb, wyc, wxc, sy, sx))
    return rows, corners


def _patch_rows(value: torch.Tensor, l: int, h: int, w: int) -> torch.Tensor:
    """``[B, L*H*W, M, D]`` -> ``[B*M*L*(H+1)*(W+1), 4*D]``: per (batch,
    head, level) map, zero-padded by one cell, the 2x2 patch at each padded
    cell, its four taps in the corners' order. One gathered row then holds a
    sample's four taps: PyTorch's row gather costs about the same per row
    whatever its width, so this takes a quarter of the time of four gathers."""
    b, _, m, d = value.shape
    v = value.reshape(b, l, h, w, m, d).permute(0, 4, 1, 2, 3, 5)  # [B, M, L, H, W, D]
    pad = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1))  # [B, M, L, H+2, W+2, D]
    patch = torch.cat([pad[..., :-1, :-1, :], pad[..., :-1, 1:, :], pad[..., 1:, :-1, :], pad[..., 1:, 1:, :]], -1)
    return patch.reshape(b * m * l * (h + 1) * (w + 1), 4 * d)


def _taps(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The four corners' taps ``[BM, Q, L*P, 4, D]`` of the patch ``rows
    [BM, Q, L, P]``."""
    bm, q, l, p = rows.shape
    return table.index_select(0, rows.reshape(-1)).view(bm, q, l * p, 4, table.shape[1] // 4)


def _forward(table, x, y, wgt, h, w):
    """``table`` (:func:`_patch_rows`), f32 pixel coords ``x/y [BM, Q, L,
    P]``, ``wgt [BM, Q, L*P]`` -> ``[BM, Q, D]`` in the value dtype: per
    corner ``cw = where(inb, wy*wx, 0).astype(dtype) * wgt`` contracted with
    the taps, the corners summed in the value dtype (`msda.py:103-122`)."""
    bm, q, l, p = x.shape
    dt = table.dtype
    rows, corners = _corners(x, y, h, w)
    taps = _taps(table, rows)
    out = torch.zeros((bm, q, taps.shape[-1]), dtype=dt, device=table.device)
    for c, (inb, wyc, wxc, _, _) in enumerate(corners):
        cw = torch.where(inb, wyc * wxc, 0.0).to(dt).view(bm, q, l * p) * wgt
        out = out + _contract(cw, taps[:, :, :, c])
    return out


def _pixel_coords(locations: torch.Tensor, h: int, w: int):
    """``[B, Q, M, L, P, 2]`` f32 locations -> ``x/y [B*M, Q, L, P]``:
    ``loc*W - 0.5`` as XLA computes it on the CPU (:func:`fma`)."""
    b, q, m, l, p, _ = locations.shape
    loc = locations.movedim(2, 1)  # [B, M, Q, L, P, 2]
    x = fma(loc[..., 0], w, -0.5).reshape(b * m, q, l, p)
    y = fma(loc[..., 1], h, -0.5).reshape(b * m, q, l, p)
    return x, y


def level_major(t: torch.Tensor, b: int, m: int, l: int) -> torch.Tensor:
    """Pixel coords ``[B*M, Q, L, P]`` -> ``[B*M*L, Q*P]``: one row of
    samples per (batch, head, level), the layout of the value gradient's B3
    call."""
    q, p = t.shape[1], t.shape[3]
    return t.reshape(b, m, q, l, p).transpose(2, 3).reshape(b * m * l, q * p)


def gather_coords(locations: torch.Tensor, h: int, w: int):
    """The coordinates ``sx, sy [B*M*L, Q*P]`` at which the backward of
    gather attention over ``locations [B, Q, M, L, P, 2]`` launches B3."""
    b, _, m, l = locations.shape[:4]
    return tuple(level_major(t, b, m, l) for t in _pixel_coords(locations, h, w))


def _check(value, spatial_shape, num_levels, locations, weights):
    h, w = (int(v) for v in spatial_shape)
    b, s, m, d = value.shape
    if (locations.dim() != 6 or locations.shape[0] != b or locations.shape[2] != m
            or locations.shape[3] != num_levels or s != num_levels * h * w
            or tuple(weights.shape) != tuple(locations.shape[:5]) or weights.dtype != value.dtype):
        raise ValueError(f"gather attention: value {tuple(value.shape)}, locations {tuple(locations.shape)} and "
                         f"weights {tuple(weights.shape)} {weights.dtype} do not fit {num_levels} levels of {h}x{w} "
                         f"in {value.dtype}")
    return h, w


def ms_deform_attn_same_shape(value: torch.Tensor, spatial_shape, num_levels: int, sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain version when all ``num_levels`` levels share ``spatial_shape``:
    (level, y, x) fold into one flat index, so each corner is one gather of
    all L*P taps. Returns ``[B, Q, M*D]``; equal to :func:`ms_deform_attn`
    on same-shape inputs up to the order of the f32 sums."""
    h, w = _check(value, spatial_shape, num_levels, sampling_locations, attention_weights)
    return gather_fwd_plain(value, sampling_locations, attention_weights, h, w)


def gather_fwd_plain(value, locations, weights, h: int, w: int) -> torch.Tensor:
    """The forward in plain PyTorch on any device: ``value [B, L*H*W, M,
    D]``, f32 ``locations [B, Q, M, L, P, 2]``, ``weights [B, Q, M, L, P]``
    in the value dtype -> ``[B, Q, M*D]``. The CPU path of
    :class:`_GatherAttnFn`, and on the card the oracle of
    :func:`msda_gather_fwd`."""
    b, _, m, d = value.shape
    _, q, _, l, p, _ = locations.shape
    x, y = _pixel_coords(locations, h, w)
    wgt = weights.movedim(2, 1).reshape(b * m, q, l * p)
    out = _forward(_patch_rows(value, l, h, w), x, y, wgt, h, w)
    return out.view(b, m, q, d).movedim(1, 2).reshape(b, q, m * d)


def gather_bwd_plain(value, locations, weights, g, h: int, w: int, value_grad: bool = True,
                     sample_grads: bool = True):
    """The backward in plain PyTorch on any device, for the cotangent ``g
    [B, Q, M*D]`` in the value dtype -> ``(sx, sy, gs, g_locations,
    g_weights)``; the first three, the value gradient's B3 inputs, None
    unless ``value_grad``, the last two None unless ``sample_grads``:

    - ``sx, sy [B*M*L, Q*P]``: the samples' f32 pixel coordinates, one row
      per (batch, head, level) map;
    - ``gs [B*M*L, Q*P, D]``: each sample's cotangent times its weight;
    - ``g_locations``: per corner ``+-wy`` (x) and ``+-wx`` (y) times the
      weight times ``<tap, g>``, rounded to the value dtype as JAX rounds
      ``dcw * wgt``, masked, summed in f32 and scaled by ``W`` (``H``);
    - ``g_weights``: ``sum_corners <tap, g> * where(inb, wy*wx, 0)`` in the
      value dtype.

    The CPU path of :class:`_GatherAttnFn`, and on the card the oracle of
    :func:`msda_gather_bwd`."""
    b, _, m, d = value.shape
    _, q, _, l, p = weights.shape
    dt = value.dtype
    x, y = _pixel_coords(locations, h, w)
    g = g.reshape(b, q, m, d).movedim(2, 1)  # [B, M, Q, D]
    sx = sy = gs = g_loc = g_wgt = None
    if value_grad:
        # each sample's cotangent times its weight, [B, M, L, Q, P, D], at its level's coordinates
        wgt_l = weights.permute(0, 2, 3, 1, 4)  # [B, M, L, Q, P]
        gs = (wgt_l[..., None] * g[:, :, None, :, None, :]).reshape(b * m * l, q * p, d)
        sx, sy = (level_major(t, b, m, l) for t in (x, y))
    if sample_grads:
        rows, corners = _corners(x, y, h, w)
        taps = _taps(_patch_rows(value, l, h, w), rows)
        del rows
        gq = g.reshape(b * m, q, d, 1)
        wgt = weights.movedim(2, 1).reshape(b * m, q, l * p)
        g_w = torch.zeros((b * m, q, l * p), dtype=dt, device=value.device)
        gx = torch.zeros(x.shape, dtype=torch.float32, device=value.device)
        gy = torch.zeros(x.shape, dtype=torch.float32, device=value.device)
        for c, (inb, wyc, wxc, sy_, sx_) in enumerate(corners):
            dot = torch.matmul(taps[:, :, :, c], gq).squeeze(-1)  # <tap, g_out>, [BM, Q, L*P]
            g_w = g_w + dot * torch.where(inb, wyc * wxc, 0.0).to(dt).reshape(dot.shape)
            t = torch.where(inb, (dot * wgt).float().reshape(x.shape), 0.0)
            gx = gx + sx_ * wyc * t
            gy = gy + sy_ * wxc * t
        g_loc = torch.stack([gx * w, gy * h], -1).reshape(b, m, q, l, p, 2).movedim(1, 2)
        g_wgt = g_w.reshape(b, m, q, l, p).movedim(1, 2)
    return sx, sy, gs, g_loc, g_wgt


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a build of ``csrc/msda_gather.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    shape = [i, ll, i, i, i, i, i, i, i]  # dtype, B*Q, Q, M, L, H, W, D, P
    lib.msda_gather_fwd_launch.argtypes = [p, p, p, p, *shape, p]
    lib.msda_gather_bwd_launch.argtypes = [p, p, p, p, *shape, p, p, p, p, p, p]
    for fn in (lib.msda_gather_fwd_launch, lib.msda_gather_bwd_launch):
        fn.restype = ctypes.c_int
    lib.msda_gather_error_string.argtypes = [ctypes.c_int]
    lib.msda_gather_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the gather kernels' shared library."""
    return bind(ctypes.CDLL(str(kernel_build.build(KERNEL_NAME))))


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"msda_gather launch failed: {lib.msda_gather_error_string(err).decode()} "
                           f"(cudaError {err})")


def check_inputs(value, locations, weights, h: int, w: int, g=None) -> None:
    """Raise ValueError on inputs the kernels do not take: shapes that do
    not fit (:func:`_check`), a dtype other than f32 or bf16, weights (or a
    cotangent ``g [B, Q, M*D]``) in another dtype than the value, locations
    that are not f32, D not a multiple of 8 or above ``MAX_HEAD_DIM``, a
    tensor that is not contiguous, and last, tensors off one CUDA device."""
    if value.dim() != 4 or locations.dim() != 6:
        raise ValueError(f"msda_gather takes value [B, S, M, D] and locations [B, Q, M, L, P, 2], got "
                         f"{tuple(value.shape)} and {tuple(locations.shape)}")
    if value.dtype not in _DTYPE_CODES:
        raise ValueError(f"msda_gather takes an f32 or bf16 value, got {value.dtype}")
    if locations.dtype != torch.float32:
        raise ValueError(f"msda_gather takes f32 locations, got {locations.dtype}")
    _check(value, (h, w), locations.shape[3], locations, weights)
    d = value.shape[3]
    if d % 8 != 0 or d > MAX_HEAD_DIM:
        raise ValueError(f"msda_gather: a head of D = {d} channels; the kernels take a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    tensors = {"value": value, "locations": locations, "weights": weights}
    if g is not None:
        b, q, m = locations.shape[:3]
        if tuple(g.shape) != (b, q, m * d) or g.dtype != value.dtype:
            raise ValueError(f"msda_gather_bwd: g {tuple(g.shape)} {g.dtype}, expected {(b, q, m * d)} "
                             f"{value.dtype}")
        tensors["g"] = g
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"msda_gather: {name} must be contiguous")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != value.device:
            raise ValueError(f"msda_gather runs on one CUDA device only, got {name} on {t.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data is not 16-byte aligned (the kernels'
    vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _shape_args(value, locations, h: int, w: int) -> tuple:
    b, q, m, l, p, _ = locations.shape
    return (_DTYPE_CODES[value.dtype], b * q, q, m, l, h, w, value.shape[3], p)


def msda_gather_fwd(value, locations, weights, h: int, w: int) -> torch.Tensor:
    """Launch the gather forward (``csrc/msda_gather.cu``): the contract of
    :func:`gather_fwd_plain` on contiguous CUDA tensors, value and weights
    in one dtype (f32 or bf16), ``D`` a multiple of 8. Raises on any input
    the kernel does not take; never computes on another path. Adds one to
    ``msda_gather_fwd.launches`` a launch."""
    check_inputs(value, locations, weights, h, w)
    b, q, m = locations.shape[:3]
    out = torch.empty((b, q, m * value.shape[3]), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    value, locations, weights = (_aligned(t) for t in (value, locations, weights))
    lib = load_library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        _raise_on(lib, lib.msda_gather_fwd_launch(value.data_ptr(), locations.data_ptr(), weights.data_ptr(),
                                                  out.data_ptr(), *_shape_args(value, locations, h, w), stream))
    msda_gather_fwd.launches += 1
    return out


msda_gather_fwd.launches = 0


def msda_gather_bwd(value, locations, weights, g, h: int, w: int, value_grad: bool = True,
                    sample_grads: bool = True):
    """Launch the gather backward (``csrc/msda_gather.cu``) for the
    cotangent ``g [B, Q, M*D]`` in the value dtype: the contract of
    :func:`gather_bwd_plain`, ``(sx, sy, gs, g_locations, g_weights)``, in
    one pass over the samples that re-reads their taps only for
    ``sample_grads``. Raises on any input the kernel does not take; never
    computes on another path. Adds one to ``msda_gather_bwd.launches`` a
    launch."""
    check_inputs(value, locations, weights, h, w, g)
    if not (value_grad or sample_grads):
        raise ValueError("msda_gather_bwd: asked for no gradient")
    b, q, m, l, p, _ = locations.shape
    d, dev = value.shape[3], value.device
    sx = sy = gs = g_loc = g_wgt = None
    if value_grad:
        sx = torch.empty((b * m * l, q * p), dtype=torch.float32, device=dev)
        sy = torch.empty((b * m * l, q * p), dtype=torch.float32, device=dev)
        gs = torch.empty((b * m * l, q * p, d), dtype=value.dtype, device=dev)
    if sample_grads:
        g_loc = torch.empty(locations.shape, dtype=torch.float32, device=dev)
        g_wgt = torch.empty(weights.shape, dtype=value.dtype, device=dev)
    if b * q == 0:
        return sx, sy, gs, g_loc, g_wgt
    value, locations, weights, g = (_aligned(t) for t in (value, locations, weights, g))
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib, lib.msda_gather_bwd_launch(
            value.data_ptr(), locations.data_ptr(), weights.data_ptr(), g.data_ptr(),
            *_shape_args(value, locations, h, w), *map(_ptr, (sx, sy, gs, g_loc, g_wgt)), stream))
    msda_gather_bwd.launches += 1
    return sx, sy, gs, g_loc, g_wgt


msda_gather_bwd.launches = 0


class _GatherAttnFn(torch.autograd.Function):
    """Gather attention with a backward free of scatters: a CUDA tensor
    through :func:`msda_gather_fwd` and :func:`msda_gather_bwd`, any other
    through :func:`gather_fwd_plain` and :func:`gather_bwd_plain`. The
    forward saves the value, the locations and the weights; the value's
    gradient is B3's (:func:`warp_scatter_accumulate`) over the backward's
    weighted cotangents ``[B*M*L, Q*P, D]`` at their level's coordinates on
    one ``H x W`` map (one call, so no tap crosses a level's boundary)."""

    @staticmethod
    def forward(ctx, value, locations, weights, h, w):
        ctx.save_for_backward(value, locations, weights)
        ctx.hw = (h, w)
        return (msda_gather_fwd if value.is_cuda else gather_fwd_plain)(value, locations, weights, h, w)

    @staticmethod
    def backward(ctx, g_out):
        value, locations, weights = ctx.saved_tensors
        h, w = ctx.hw
        b, _, m, d = value.shape
        l = locations.shape[3]
        need_value, need_loc, need_wgt = ctx.needs_input_grad[:3]
        bwd = msda_gather_bwd if value.is_cuda else gather_bwd_plain
        sx, sy, gs, g_loc, g_wgt = bwd(value, locations, weights, g_out.to(value.dtype).contiguous(), h, w,
                                       value_grad=need_value, sample_grads=need_loc or need_wgt)
        g_value = None
        if need_value:
            gv = warp_scatter_accumulate(gs, sx, sy, h, w)  # [B*M*L, H, W, D]
            del gs, sx, sy
            g_value = gv.reshape(b, m, l, h * w, d).permute(0, 2, 3, 1, 4).reshape(b, l * h * w, m, d)
        return g_value, g_loc if need_loc else None, g_wgt if need_wgt else None, None, None


def ms_deform_attn_gather(value: torch.Tensor, spatial_shape, num_levels: int, locations: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Gather-mode attention with device dispatch, differentiable in all
    three inputs: the contract of :func:`ms_deform_attn_same_shape`. A CUDA
    tensor launches ``csrc/msda_gather.cu`` forward and backward, and B3 for
    the value's gradient (or raises); a CPU tensor runs the plain path.
    ``locations`` are taken in f32."""
    if value.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ms_deform_attn_gather: unsupported device {value.device}")
    h, w = _check(value, spatial_shape, num_levels, locations, weights)
    return _GatherAttnFn.apply(value.contiguous(), locations.to(torch.float32).contiguous(), weights.contiguous(),
                               h, w)
