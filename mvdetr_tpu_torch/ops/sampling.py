"""Bilinear sampling, port of ``mvdetr_tpu/ops/sampling.py::bilinear_patch_sample``.

Convention: integer pixel centers. Pixel ``i`` of an axis of size ``W`` is
centered at coordinate ``i``; the support is ``[-0.5, W - 0.5]``. Each of the
four corners is masked on its own, so taps outside the image contribute zero.

Forward only in this slice: the warp's backward (TPU kernel
``ops/pallas/warp_bwd.py::_kernel``) comes with the training slice.
"""

from __future__ import annotations

import torch


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
