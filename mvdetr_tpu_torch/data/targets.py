"""Training targets (host-side numpy, fixed shapes), a copy of
``mvdetr_tpu/data/targets.py``.

- heatmap: max-composited Gaussian splats with sigma = kernel_size / reduce
  and radius = int(3 * sigma);
- per-object arrays padded to ``top_k``: validity mask, flattened cell index,
  person id, sub-cell offset and (optionally) box width/height, all in
  reduced-grid units.

As in the JAX package, :func:`build_targets` splats through the native
library (:func:`mvdetr_tpu_torch.native.splat_gaussian`, a copy of the JAX
package's C++ splat); :func:`splat_gaussian` is the numpy version it is
held against.
"""

from __future__ import annotations

import numpy as np

from mvdetr_tpu_torch import native


def gaussian2d(shape, sigma: float = 1.0) -> np.ndarray:
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def splat_gaussian(heatmap: np.ndarray, center_xy, sigma: float, k: float = 1.0) -> np.ndarray:
    """Max-composite a Gaussian of ``radius = int(3*sigma)`` at integer center
    (x, y) into ``heatmap [H, W]`` in place."""
    radius = int(3 * sigma)
    diameter = 2 * radius + 1
    g = gaussian2d((diameter, diameter), sigma=sigma)
    x, y = int(center_xy[0]), int(center_xy[1])
    hgt, wid = heatmap.shape
    left, right = min(x, radius), min(wid - x, radius + 1)
    top, bottom = min(y, radius), min(hgt - y, radius + 1)
    if right + left > 0 and bottom + top > 0:
        masked = heatmap[y - top : y + bottom, x - left : x + right]
        np.maximum(masked, g[radius - top : radius + bottom, radius - left : radius + right] * k, out=masked)
    return heatmap


def build_targets(reduced_shape, x_s, y_s, w_s=None, h_s=None, pids=None, reduce: int = 4, top_k: int = 100,
                  kernel_size: float = 4.0) -> dict:
    """Fixed-shape target dict for one map. Coordinates enter in *unreduced*
    units and are divided by ``reduce``."""
    hgt, wid = (int(v) for v in reduced_shape)
    heatmap = np.zeros([hgt, wid, 1], dtype=np.float32)
    reg_mask = np.zeros([top_k], dtype=bool)
    idx = np.zeros([top_k], dtype=np.int64)
    pid = np.zeros([top_k], dtype=np.int64)
    offset = np.zeros([top_k, 2], dtype=np.float32)
    wh = np.zeros([top_k, 2], dtype=np.float32)

    centers = []
    for k in range(min(len(x_s), top_k)):
        ct = np.array([x_s[k] / reduce, y_s[k] / reduce], dtype=np.float32)
        if 0 <= ct[0] < wid and 0 <= ct[1] < hgt:
            ct_int = ct.astype(np.int32)
            centers.append(ct_int)
            reg_mask[k] = True
            idx[k] = ct_int[1] * wid + ct_int[0]
            pid[k] = pids[k] if pids is not None else 0
            offset[k] = ct - ct_int
            if w_s is not None and h_s is not None:
                wh[k] = [w_s[k] / reduce, h_s[k] / reduce]
    if centers:
        native.splat_gaussian(heatmap[:, :, 0], np.stack(centers), kernel_size / reduce)

    out = {"heatmap": heatmap, "reg_mask": reg_mask, "idx": idx, "pid": pid, "offset": offset}
    if w_s is not None and h_s is not None:
        out["wh"] = wh
    return out
