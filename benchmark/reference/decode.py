"""The detector's answer, in plain PyTorch: the BEV heatmap's cells decoded
to ground positions, the top candidates and greedy distance NMS (MVDeTr's
``mvdet_decode`` and ``nms``)."""

from __future__ import annotations

import numpy as np
import torch


def dense_decode(world_heatmap: torch.Tensor, world_offset: torch.Tensor, reduce: int):
    """NHWC logits ``[1, H, W, 1]`` and offsets ``[1, H, W, 2]`` of one frame
    set -> every cell's ``(x, y)`` in full-resolution grid units ``[H*W, 2]``
    (``(cell + offset) * reduce``) and its logit ``[H*W]``, f64."""
    _, h, w, _ = world_heatmap.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=world_heatmap.device),
                            torch.arange(w, dtype=torch.float64, device=world_heatmap.device), indexing="ij")
    xy = (torch.stack([xs, ys], -1).reshape(h * w, 2) + world_offset.reshape(h * w, 2).double()) * reduce
    return xy, world_heatmap.reshape(h * w).double()


def top_candidates(xy: torch.Tensor, logit: torch.Tensor, k: int):
    """The ``k`` highest cells by score, ties in cell order: ``[k, 3]``
    rows (x, y, score)."""
    score = torch.sigmoid(logit)
    order = torch.sort(score, descending=True, stable=True).indices[:k]
    return torch.cat([xy[order], score[order, None]], dim=1)


def greedy_nms(points: np.ndarray, scores: np.ndarray, dist: float) -> np.ndarray:
    """Keep mask of greedy NMS in f32: walk the candidates by descending
    score (equal scores in descending index order) and drop every later
    one within ``dist`` (``d^2 <= dist^2``) of a kept one."""
    pts = np.asarray(points, dtype=np.float32)
    order = np.argsort(np.asarray(scores, dtype=np.float32), kind="stable")[::-1]
    keep = np.zeros(len(order), dtype=bool)
    alive = np.ones(len(order), dtype=bool)
    thr2 = np.float32(dist) * np.float32(dist)
    for rank, i in enumerate(order):
        if not alive[rank]:
            continue
        keep[i] = True
        later = order[rank + 1:]
        diff = pts[later] - pts[i]
        d2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
        alive[rank + 1:] &= ~(d2 <= thr2)
    return keep
