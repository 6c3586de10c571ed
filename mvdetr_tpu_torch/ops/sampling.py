"""Bilinear sampling and its adjoint, port of ``mvdetr_tpu/ops/sampling.py``
(``bilinear_gather``, ``bilinear_patch_sample``, ``bilinear_scatter_matmul``),
and :func:`bilinear_corners`, the corner arithmetic that ``bilinear_gather``
and the deformable convolution's backward share.

Convention: integer pixel centers. Pixel ``i`` of an axis of size ``W`` is
centered at coordinate ``i``; the support is ``[-0.5, W - 0.5]``. Each of the
four corners is masked on its own, so taps outside the image contribute zero.

:func:`bilinear_scatter_matmul` is the plain version of the warp backward
(TPU kernel B3, ``mvdetr_tpu/ops/pallas/warp_bwd.py::_kernel``); its CUDA
kernel is ``csrc/warp_bwd.cu`` behind :func:`mvdetr_tpu_torch.ops.warp.warp_bwd`.
"""

from __future__ import annotations

import torch


def bilinear_corners(x: torch.Tensor, y: torch.Tensor, h: int, w: int) -> list:
    """The four corners of bilinear sampling at pixel coords ``x/y`` on an
    ``h x w`` map, in JAX's order (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1,
    x0+1), each as ``(index, inb, wy, wx, sign_y, sign_x)``: the flat index
    of the corner clamped into the map (int64), whether the corner lies
    inside it, its two axis weights in the coordinates' dtype (``x0 =
    floor(x)``, ``wx1 = x - x0``, ``wx0 = 1 - wx1``), and the signs of their
    slopes in ``y`` and ``x``."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    corners = []
    for yc, xc, wyc, wxc, sy, sx in ((y0, x0, wy0, wx0, -1.0, -1.0), (y0, x0 + 1.0, wy0, wx1, -1.0, 1.0),
                                     (y0 + 1.0, x0, wy1, wx0, 1.0, -1.0), (y0 + 1.0, x0 + 1.0, wy1, wx1, 1.0, 1.0)):
        inb = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        idx = torch.clamp(yc, 0, h - 1).to(torch.int64) * w + torch.clamp(xc, 0, w - 1).to(torch.int64)
        corners.append((idx, inb, wyc, wxc, sy, sx))
    return corners


def bilinear_gather(flat_value: torch.Tensor, x: torch.Tensor, y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Sample ``flat_value [..., H*W, C]`` at pixel coords ``x/y [..., Q]``
    (the same leading axes) -> ``[..., Q, C]``, zero outside the map.

    The JAX function's op order (:func:`bilinear_corners`): each corner's
    weight ``where(inb, wy*wx, 0)`` cast to the value dtype, the tap times
    its weight and the four corners summed in the value dtype, in order.
    """
    c = flat_value.shape[-1]
    out = None
    for idx, inb, wyc, wxc, _, _ in bilinear_corners(x, y, h, w):
        tap = torch.gather(flat_value, -2, idx[..., None].expand(*idx.shape, c))
        weight = torch.where(inb, wyc * wxc, 0.0).to(flat_value.dtype)
        contrib = tap * weight[..., None]
        out = contrib if out is None else out + contrib
    return out


def bilinear_patch_sample(value: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``value [B, H, W, C]``, ``x/y [B, Q]`` pixel coords -> ``[B, Q, C]``.

    Mirrors the JAX function op for op: the fractional weights are cast to the
    value dtype before the per-corner products, the 2x2 patch is read from a
    one-pixel zero-padded copy at a clamped start (far-out queries already
    have zero weight), and the four taps are contracted with one rounding to
    the value dtype at the end.
    """
    b, h, w, c = value.shape
    q = x.shape[1]
    dt = value.dtype
    padded = torch.nn.functional.pad(value, (0, 0, 1, 1, 1, 1))  # [B, H+2, W+2, C]

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = (x - x0).to(dt)
    wy1 = (y - y0).to(dt)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def inb(xc, yc):
        return ((xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)).to(dt)

    weights = torch.stack(
        [
            wy0 * wx0 * inb(x0, y0),
            wy0 * wx1 * inb(x0 + 1, y0),
            wy1 * wx0 * inb(x0, y0 + 1),
            wy1 * wx1 * inb(x0 + 1, y0 + 1),
        ],
        dim=-1,
    )  # [B, Q, 4]

    ys = torch.clamp(y0 + 1.0, 0, h).to(torch.int64)
    xs = torch.clamp(x0 + 1.0, 0, w).to(torch.int64)
    wp = w + 2
    start = ys * wp + xs + (torch.arange(b, device=value.device) * (h + 2) * wp)[:, None]
    flat = padded.reshape(b * (h + 2) * wp, c)
    corner_offsets = torch.tensor([0, 1, wp, wp + 1], device=value.device)
    idx = (start[..., None] + corner_offsets).reshape(-1)  # [B*Q*4]
    patches = flat.index_select(0, idx).reshape(b, q, 4, c)
    out = torch.einsum("bqk,bqkc->bqc", weights.float(), patches.float())
    return out.to(dt)


def bilinear_scatter_matmul(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor, h: int, w: int,
                            chunk: int = 4096) -> torch.Tensor:
    """Adjoint of bilinear sampling with respect to the sampled map:
    ``g [B, Q, C]`` cotangents of samples taken at ``x/y [B, Q]`` ->
    ``grad [B, h, w, C]`` in ``g.dtype``.

    ``grad[b, i, j, c] = sum_q R[q, i] * C[q, j] * g[b, q, c]`` with ``R``
    ``[Q, h]`` and ``C`` ``[Q, w]`` the separable bilinear one-hots of
    ``floor(y)`` and ``floor(x)``, built from f32 coordinates; taps outside the
    map match no index and vanish. The roundings are the JAX function's:
    ``R`` is cast to ``g.dtype`` and the ``R (x) g`` product taken in
    ``g.dtype``; ``C`` is cast to ``g.dtype`` and the contraction over queries
    accumulates in f32 (bf16 products are exact in f32), chunk by chunk; the
    result is cast to ``g.dtype`` once.
    """
    b, qn, c = g.shape
    dt = g.dtype
    chunk = min(chunk, qn)
    nchunk = -(-qn // chunk)
    qp = nchunk * chunk
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if qp != qn:
        g = torch.nn.functional.pad(g, (0, 0, 0, qp - qn))
        # padded queries sample far outside the map: zero weights
        x = torch.nn.functional.pad(x, (0, qp - qn), value=-1e6)
        y = torch.nn.functional.pad(y, (0, qp - qn), value=-1e6)
    rows = torch.arange(h, dtype=torch.float32, device=g.device)
    cols = torch.arange(w, dtype=torch.float32, device=g.device)
    acc = torch.zeros((b, w, h * c), dtype=torch.float32, device=g.device)
    for i in range(nchunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        xx, yy, gg = x[:, sl], y[:, sl], g[:, sl]
        x0 = torch.floor(xx)
        y0 = torch.floor(yy)
        wx1 = xx - x0
        wy1 = yy - y0
        r1h = ((1.0 - wy1)[..., None] * (rows == y0[..., None])
               + wy1[..., None] * (rows == (y0 + 1.0)[..., None]))  # [B, CH, h]
        c1h = ((1.0 - wx1)[..., None] * (cols == x0[..., None])
               + wx1[..., None] * (cols == (x0 + 1.0)[..., None]))  # [B, CH, w]
        rg = r1h.to(dt)[..., None] * gg[:, :, None, :]  # [B, CH, h, C] in g.dtype
        acc += torch.bmm(c1h.to(dt).float().transpose(1, 2), rg.reshape(b, chunk, h * c).float())
    return acc.reshape(b, w, h, c).transpose(1, 2).to(dt)
