"""Training losses, port of ``mvdetr_tpu/losses.py``.

NHWC predictions (raw logits) against fixed-size, top-K padded targets:

- :func:`focal_loss`: CornerNet focal loss; positives are the cells where the
  target is exactly 1, negatives are weighted by ``(1 - t)^4``, and the total
  is divided by the positive count.
- :func:`reg_l1_loss`: masked L1 at the ground-truth cells, divided by
  ``sum(mask) + 1e-4``.
- :func:`gaussian_mse_loss`: the plain MSE of ``--use_mse``;
- :func:`reg_ce_loss`: masked cross-entropy at the ground-truth cells (the
  reID head's loss, unused at the default ``id_ratio=0``);
- :func:`gaussian_smoothed_mse_loss`: MVDet's GaussianMSE (the target
  max-pooled to the output's size, blurred with a peak-normalised Gaussian).

Each takes a ``group``: the process group of a data-sharded mesh's ``data``
axis, over which JAX takes every normaliser (positive count, mask sum,
element count) from the global batch. The counts are summed over the group
before the division (the element count is the group's size times the
rank's, every rank holding as many frames), so each rank's loss is its share
of the global loss and
the shares' gradients add up across the ranks; a rank with no positives
still takes the global branch of the focal loss. Without a group (None) the
batch is the whole batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvdetr_tpu_torch.parallel.collectives import group_size, reduce_sum


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(x), 1e-4, 1.0 - 1e-4)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None,
               group=None) -> torch.Tensor:
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
    num_pos = reduce_sum(pos.sum(), group)
    pos_sum = pos_loss.sum()
    neg_sum = neg_loss.sum()
    return torch.where(num_pos == 0, -neg_sum, -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0))


def gather_at_indices(output: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``output [B, H, W, C]`` at flat row-major indices ``idx [B, K]`` -> ``[B, K, C]``."""
    b, h, w, c = output.shape
    flat = output.reshape(b, h * w, c)
    return torch.take_along_dim(flat, idx.long()[..., None], dim=1)


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, target: torch.Tensor,
                group=None) -> torch.Tensor:
    """``output [B, H, W, C]``, ``mask [B, K]``, ``idx [B, K]``, ``target
    [B, K, C]`` -> scalar masked L1."""
    pred = gather_at_indices(output, idx)
    m = mask.to(pred.dtype)[..., None] * torch.ones_like(pred)
    loss = torch.abs(pred * m - target * m).sum()
    return loss / (reduce_sum(m.sum(), group) + 1e-4)


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch: its own
    mean over the group's size (every rank holds as many frames)."""
    return torch.mean(x) if group is None else torch.mean(x) / group_size(group)


def gaussian_mse_loss(output: torch.Tensor, target: torch.Tensor, group=None) -> torch.Tensor:
    """Plain MSE between the raw heatmap output and the Gaussian target
    (`trainer.py:64-66` of the reference feeds the head output to MSE without
    a sigmoid)."""
    return _mean((output - target) ** 2, group)


def reg_ce_loss(output: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor, target: torch.Tensor,
                group=None) -> torch.Tensor:
    """``output [B, H, W, C]`` class logits, ``mask [B, K]``, ``idx [B, K]``,
    ``target [B, K]`` int class ids -> scalar: ``-sum(log_softmax(pred)[target]
    * mask) / (sum(mask) + 1e-4)`` (`mvdetr_tpu/losses.py:85-97`)."""
    pred = gather_at_indices(output, idx)
    logp = torch.log_softmax(pred, dim=-1)
    picked = torch.take_along_dim(logp, target.long()[..., None], dim=-1)[..., 0]
    m = mask.to(pred.dtype)
    return -(picked * m).sum() / (reduce_sum(m.sum(), group) + 1e-4)


def gaussian_smoothed_mse_loss(output: torch.Tensor, target: torch.Tensor, kernel_size: int = 10,
                               group=None) -> torch.Tensor:
    """``output [B, Ho, Wo, 1]``, ``target [B, Ht, Wt, 1]`` -> scalar
    (`mvdetr_tpu/losses.py:100-123`): the target max-pooled by the integer
    size ratio (VALID) when the sizes differ, blurred with a
    ``(2r+1) x (2r+1)`` Gaussian (sigma ``kernel_size / 4``, ``r = int(2 *
    sigma)``, peak 1) with zero ``SAME`` padding, then the MSE against the
    raw output."""
    ho, wo = output.shape[1:3]
    ht, wt = target.shape[1:3]
    t = target.permute(0, 3, 1, 2)
    if (ht, wt) != (ho, wo):
        t = F.max_pool2d(t, (ht // ho, wt // wo))
    sigma = kernel_size / 4.0
    radius = int(2 * sigma)
    ax = torch.arange(-radius, radius + 1, dtype=torch.float32, device=target.device)
    g1 = torch.exp(-(ax**2) / (2 * sigma**2))
    g2 = torch.outer(g1, g1)
    blurred = F.conv2d(t, (g2 / g2.max()).to(t.dtype)[None, None], padding=radius)
    return _mean((output - blurred.permute(0, 2, 3, 1)) ** 2, group)
