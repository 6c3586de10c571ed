"""2D sine positional embeddings (DETR-style).

Numerical contract from `multiview_detector/models/trans_world_feat.py:15-37`
(``create_pos_embedding``): cumulative-count embeds normalized to [~0, 2*pi],
sin/cos interleaved per axis, y-features then x-features along channels.
Computed once in numpy and baked into jitted programs as a constant.

Copied unchanged (imports aside) from ``mvdetr_tpu/models/pos_embed.py``; the port keeps its own
copy so that it never imports the JAX package.
"""

from __future__ import annotations

import math

import numpy as np


def sine_pos_embedding(img_size, num_pos_feats: int = 64, temperature: float = 10000.0) -> np.ndarray:
    """Returns ``[H, W, 2 * num_pos_feats]`` float32 (NHWC; channels = [y | x])."""
    h, w = (int(x) for x in img_size)
    scale = 2.0 * math.pi
    eps = 1e-6
    y_embed = np.cumsum(np.ones((h, w), dtype=np.float64), axis=0)
    x_embed = np.cumsum(np.ones((h, w), dtype=np.float64), axis=1)
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2.0 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=2).astype(np.float32)


def coord_map(img_size, with_r: bool = False) -> np.ndarray:
    """[-1, 1] coordinate map, ``[H, W, 2(+1)]`` (`conv_world_feat.py:9-18`)."""
    h, w = (int(x) for x in img_size)
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    gx = (gx / (w - 1) * 2 - 1).astype(np.float32)
    gy = (gy / (h - 1) * 2 - 1).astype(np.float32)
    ret = np.stack([gx, gy], axis=-1)
    if with_r:
        ret = np.concatenate([ret, np.sqrt(gx**2 + gy**2)[..., None]], axis=-1)
    return ret
