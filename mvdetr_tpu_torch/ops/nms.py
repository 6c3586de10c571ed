"""Ground-plane distance NMS, port of ``mvdetr_tpu/ops/nms.py``.

Greedy: walk the candidates by descending score and drop every later
candidate within ``dist_thres`` of a kept one. A tie at exactly
``dist_thres`` is dropped (``d2 <= thr2``, `nms.py:44`); invalid candidates are
never kept and never suppress.

The JAX version walks the K candidates one by one in a ``fori_loop``. Here
the same greedy result is reached as the fixed point of

    keep[j] = valid[j] and not any(keep[i] and hit[i, j] for i < j)

iterated from ``keep = valid``: every pass is one batched ``[K, K]``
reduction, and after ``t`` passes every candidate whose chain of possible
suppressors is shorter than ``t`` is final. The fixed point is unique (each
``keep[j]`` depends only on earlier candidates), so the loop stops at the
first pass that changes nothing, after at most K + 1 passes.
"""

from __future__ import annotations

import torch


def distance_nms(
    points: torch.Tensor,
    scores: torch.Tensor,
    dist_thres: float,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """``points [..., K, 2]``, ``scores [..., K]``, optional ``valid [..., K]``
    bool -> keep mask ``[..., K]`` in input order. Leading axes are batch."""
    k = scores.shape[-1]
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    key = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    # jnp.argsort is stable ascending; reversing it puts equal scores in
    # descending index order
    order = torch.argsort(key, dim=-1, stable=True).flip(-1)
    pts = torch.take_along_dim(points, order[..., None], dim=-2)
    val = torch.take_along_dim(valid, order, dim=-1)

    d2 = ((pts[..., :, None, :] - pts[..., None, :, :]) ** 2).sum(-1)
    thr2 = torch.tensor(dist_thres, dtype=d2.dtype, device=d2.device) ** 2
    later = torch.ones(k, k, dtype=torch.bool, device=d2.device).triu(diagonal=1)
    hit = later & (d2 <= thr2)  # hit[..., i, j]: a kept i removes the later j

    keep = val
    for _ in range(k + 1):
        suppressed = (hit & keep[..., :, None]).any(dim=-2)
        new = val & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros_like(keep).scatter(-1, order, keep)
