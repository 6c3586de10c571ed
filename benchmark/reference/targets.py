"""Training targets of one map, in plain numpy (CenterNet's, as MVDeTr's
``frameDataset.py`` builds them): Gaussian splats of sigma ``kernel_size /
reduce`` max-composited into a heatmap, and per-object arrays padded to
``top_k`` (mask, flat cell index, sub-cell offset, box size)."""

from __future__ import annotations

import numpy as np


def gaussian2d(diameter: int, sigma: float) -> np.ndarray:
    m = (diameter - 1.0) / 2.0
    y, x = np.ogrid[-m:m + 1, -m:m + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def splat(heatmap: np.ndarray, cx: int, cy: int, sigma: float) -> None:
    radius = int(3 * sigma)
    g = gaussian2d(2 * radius + 1, sigma)
    hgt, wid = heatmap.shape
    left, right = min(cx, radius), min(wid - cx, radius + 1)
    top, bottom = min(cy, radius), min(hgt - cy, radius + 1)
    if right + left > 0 and bottom + top > 0:
        region = heatmap[cy - top:cy + bottom, cx - left:cx + right]
        np.maximum(region, g[radius - top:radius + bottom, radius - left:radius + right], out=region)


def build_targets(shape, xs, ys, ws=None, hs=None, reduce: int = 4, top_k: int = 100,
                  kernel_size: float = 10.0) -> dict:
    """Targets of a ``shape`` map; positions and sizes in unreduced units."""
    hgt, wid = (int(v) for v in shape)
    heatmap = np.zeros([hgt, wid], dtype=np.float32)
    reg_mask = np.zeros([top_k], dtype=bool)
    idx = np.zeros([top_k], dtype=np.int64)
    offset = np.zeros([top_k, 2], dtype=np.float32)
    wh = np.zeros([top_k, 2], dtype=np.float32)
    for k in range(min(len(xs), top_k)):
        ct = np.array([xs[k] / reduce, ys[k] / reduce], dtype=np.float32)
        if 0 <= ct[0] < wid and 0 <= ct[1] < hgt:
            ci = ct.astype(np.int32)
            reg_mask[k] = True
            idx[k] = ci[1] * wid + ci[0]
            offset[k] = ct - ci
            if ws is not None:
                wh[k] = [ws[k] / reduce, hs[k] / reduce]
            splat(heatmap, int(ci[0]), int(ci[1]), kernel_size / reduce)
    out = {"heatmap": heatmap[:, :, None], "reg_mask": reg_mask, "idx": idx,
           "pid": np.arange(top_k, dtype=np.int64) * reg_mask, "offset": offset}
    if ws is not None:
        out["wh"] = wh
    return out
