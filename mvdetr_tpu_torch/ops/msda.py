"""Multi-scale deformable attention in ``gather`` mode, port of
``mvdetr_tpu/ops/msda.py``.

Contract (the JAX module's docstring)::

    value           [B, S, M, D]        S = sum_l H_l * W_l, level-major
    sampling_loc    [B, Q, M, L, P, 2]  per-level coords in [0, 1], f32
    attn_weight     [B, Q, M, L, P]     softmaxed over (L, P), value dtype
    out[b,q,m,:] = sum_{l,p} w * bilinear(value_l, x = loc_x*W_l - 0.5, y = loc_y*H_l - 0.5)
    -> [B, Q, M*D]

with every corner outside its level masked on its own. JAX runs this as a
plain XLA gather with no Pallas kernel, so the forward here is a plain torch
gather too (:func:`ms_deform_attn_same_shape`).

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
``x - floor(x)`` alone).

The pixel coordinates are XLA's on the CPU, bit for bit: XLA contracts
``loc * W - 0.5`` into one fused multiply-add, rounded once, and so does
:func:`fma` (the models' ``ref + offsets / [W, H]`` likewise, see
``models/deformable.py``). Where an offset is an integer, as the radial init
makes most of them, ``x`` lies within an ulp of an integer and a second
rounding would move ``floor(x)`` to the next cell: the forward is continuous
there, but the offsets' gradient is not.
"""

from __future__ import annotations

import torch

from mvdetr_tpu_torch.ops.sampling import bilinear_gather
from mvdetr_tpu_torch.ops.warp import warp_scatter_accumulate


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
    b, _, m, d = value.shape
    q = sampling_locations.shape[1]
    x, y = _pixel_coords(sampling_locations, h, w)
    wgt = attention_weights.movedim(2, 1).reshape(b * m, q, -1)
    out = _forward(_patch_rows(value, num_levels, h, w), x, y, wgt, h, w)
    return out.view(b, m, q, d).movedim(1, 2).reshape(b, q, m * d)


class _GatherAttnFn(torch.autograd.Function):
    """:func:`ms_deform_attn_same_shape` with a backward free of scatters.

    The forward saves the value, the f32 pixel coordinates and the weights;
    the backward re-gathers the taps from the value one corner at a time:

    - ``g_value``: the weight times the cotangent, ``[B*M*L, Q*P, D]``, into
      :func:`warp_scatter_accumulate` at that level's coordinates on one
      ``H x W`` map (one call, so no tap crosses a level's boundary);
    - ``g_locations``: per corner ``+-wy`` (x) and ``+-wx`` (y) times the
      weight times ``<tap, g_out>``, rounded to the value dtype as JAX rounds
      ``dcw * wgt``, masked, summed in f32 and scaled by ``W`` (``H``);
    - ``g_weights``: ``sum_corners <tap, g_out> * where(inb, wy*wx, 0)`` in
      the value dtype.
    """

    @staticmethod
    def forward(ctx, value, locations, weights, h, w):
        b, _, m, d = value.shape
        _, q, _, l, p, _ = locations.shape
        x, y = _pixel_coords(locations, h, w)
        wgt = weights.movedim(2, 1).reshape(b * m, q, l * p)
        out = _forward(_patch_rows(value, l, h, w), x, y, wgt, h, w)
        ctx.save_for_backward(value, x, y, weights)
        ctx.hw = (h, w)
        return out.view(b, m, q, d).movedim(1, 2).reshape(b, q, m * d)

    @staticmethod
    def backward(ctx, g_out):
        value, x, y, weights = ctx.saved_tensors
        h, w = ctx.hw
        b, _, m, d = value.shape
        _, q, _, l, p = weights.shape
        dt = value.dtype
        g = g_out.to(dt).reshape(b, q, m, d).movedim(2, 1)  # [B, M, Q, D]
        g_value = g_loc = g_wgt = None
        if ctx.needs_input_grad[0]:
            # each sample's cotangent times its weight, [B, M, L, Q, P, D], at its level's coordinates
            wgt_l = weights.permute(0, 2, 3, 1, 4)  # [B, M, L, Q, P]
            gs = (wgt_l[..., None] * g[:, :, None, :, None, :]).reshape(b * m * l, q * p, d)
            sx, sy = (level_major(t, b, m, l) for t in (x, y))
            gv = warp_scatter_accumulate(gs, sx, sy, h, w)  # [B*M*L, H, W, D]
            del gs, sx, sy
            g_value = gv.reshape(b, m, l, h * w, d).permute(0, 2, 3, 1, 4).reshape(b, l * h * w, m, d)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
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
            if ctx.needs_input_grad[1]:
                g_loc = torch.stack([gx * w, gy * h], -1).reshape(b, m, q, l, p, 2).movedim(1, 2)
            if ctx.needs_input_grad[2]:
                g_wgt = g_w.reshape(b, m, q, l, p).movedim(1, 2)
        return g_value, g_loc, g_wgt, None, None


def ms_deform_attn_gather(value: torch.Tensor, spatial_shape, num_levels: int, locations: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Gather-mode attention with device dispatch, differentiable in all
    three inputs: the contract of :func:`ms_deform_attn_same_shape`. The
    backward of a CUDA tensor launches B3 (or raises); a CPU tensor runs the
    plain adjoint. ``locations`` are taken in f32."""
    if value.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ms_deform_attn_gather: unsupported device {value.device}")
    h, w = _check(value, spatial_shape, num_levels, locations, weights)
    return _GatherAttnFn.apply(value, locations.to(torch.float32), weights, h, w)
