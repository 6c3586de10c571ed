"""Detection decoding, port of ``mvdetr_tpu/ops/decode.py`` (fixed shapes, NHWC)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def heatmap_peaks(scoremap: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Keep only the local maxima of ``scoremap [B, H, W, C]``; the window is
    padded with -inf, as ``lax.reduce_window`` pads it."""
    pad = (kernel_size - 1) // 2
    hmax = F.max_pool2d(scoremap.permute(0, 3, 1, 2), kernel_size, stride=1, padding=pad)
    hmax = hmax.permute(0, 2, 3, 1)
    return torch.where(hmax == scoremap, scoremap, torch.zeros_like(scoremap))


def mvdet_decode(scoremap: torch.Tensor, offset: torch.Tensor | None = None, reduce: int = 4) -> torch.Tensor:
    """Dense decode. ``scoremap [B, H, W, 1]`` (already sigmoided),
    ``offset [B, H, W, 2]`` -> ``[B, H*W, 3]`` rows of (x, y, score) in
    full-resolution grid units."""
    b, h, w, _ = scoremap.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=scoremap.device),
        torch.arange(w, dtype=torch.float32, device=scoremap.device),
        indexing="ij",
    )
    xy = torch.stack([xs, ys], dim=-1).reshape(1, h * w, 2).expand(b, h * w, 2)
    xy = xy + offset.reshape(b, h * w, 2) if offset is not None else xy + 0.5
    xy = xy * reduce
    return torch.cat([xy, scoremap.reshape(b, h * w, 1)], dim=-1)


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, descending, equal
    values in index order (a stable sort; ``torch.topk`` does not promise
    an order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
