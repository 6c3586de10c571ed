"""Training losses, port of ``mvdetr_tpu/losses.py:25-82``.

NHWC predictions (raw logits) against fixed-size, top-K padded targets:

- :func:`focal_loss`: CornerNet focal loss; positives are the cells where the
  target is exactly 1, negatives are weighted by ``(1 - t)^4``, and the total
  is divided by the positive count.
- :func:`reg_l1_loss`: masked L1 at the ground-truth cells, divided by
  ``sum(mask) + 1e-4``.
- :func:`gaussian_mse_loss`: the plain MSE of ``--use_mse``.
"""

from __future__ import annotations

import torch


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(x), 1e-4, 1.0 - 1e-4)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """``logits``/``target`` ``[B, H, W, C]``; ``mask`` optionally gates the
    negative term. Returns a scalar."""
    p = clamped_sigmoid(logits)
    pos = (target == 1.0).to(p.dtype)
    neg = (target < 1.0).to(p.dtype)
    neg_weights = torch.pow(1.0 - target, 4)
    pos_loss = torch.log(p) * torch.pow(1.0 - p, 2) * pos
    neg_loss = torch.log(1.0 - p) * torch.pow(p, 2) * neg_weights * neg
    if mask is not None:
        neg_loss = neg_loss * mask
    num_pos = pos.sum()
    pos_sum = pos_loss.sum()
    neg_sum = neg_loss.sum()
    return torch.where(num_pos == 0, -neg_sum, -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0))


def gather_at_indices(output: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``output [B, H, W, C]`` at flat row-major indices ``idx [B, K]`` -> ``[B, K, C]``."""
    b, h, w, c = output.shape
    flat = output.reshape(b, h * w, c)
    return torch.take_along_dim(flat, idx.long()[..., None], dim=1)


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``output [B, H, W, C]``, ``mask [B, K]``, ``idx [B, K]``, ``target
    [B, K, C]`` -> scalar masked L1."""
    pred = gather_at_indices(output, idx)
    m = mask.to(pred.dtype)[..., None] * torch.ones_like(pred)
    loss = torch.abs(pred * m - target * m).sum()
    return loss / (m.sum() + 1e-4)


def gaussian_mse_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain MSE between the raw heatmap output and the Gaussian target
    (`trainer.py:64-66` of the reference feeds the head output to MSE without
    a sigmoid)."""
    return torch.mean((output - target) ** 2)
