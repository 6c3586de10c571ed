"""Serving step, port of ``mvdetr_tpu/train/trainer.py::eval_step`` (`:92-131`).

forward at inference -> sigmoid -> dense ``mvdet_decode`` -> top-K
candidates -> per-sample greedy ``distance_nms``. All shapes are fixed: the
result is K candidates per frame set and a keep mask. The supervised loss
term of the JAX eval step comes with the training slice.
"""

from __future__ import annotations

import torch

from mvdetr_tpu_torch.device import resolve_device
from mvdetr_tpu_torch.ops import distance_nms, mvdet_decode, top_k


def decode_detections(world_heatmap: torch.Tensor, world_offset: torch.Tensor, world_reduce: int = 4,
                      num_candidates: int = 512, nms_dist: float = 20.0):
    """BEV head outputs (NHWC logits) -> ``(xys [B, K, 3], keep [B, K])``;
    rows are (x, y, score) in full-resolution grid units."""
    score = torch.sigmoid(world_heatmap)
    xys = mvdet_decode(score, world_offset, reduce=world_reduce)  # [B, HW, 3]
    k = min(num_candidates, xys.shape[1])
    top_scores, top_idx = top_k(xys[:, :, 2], k)
    top_xy = torch.take_along_dim(xys[:, :, :2], top_idx[..., None], dim=1)
    keep = distance_nms(top_xy, top_scores, nms_dist)
    return torch.cat([top_xy, top_scores[..., None]], dim=-1), keep


@torch.inference_mode()
def eval_step(model, batch: dict, world_reduce: int = 4, num_candidates: int = 512, nms_dist: float = 20.0,
              device="cuda"):
    """Serve one batch of frame sets.

    ``batch``: ``{"imgs": [B, N, H, W, 3] uint8, "affine_mats": [B, N, 3, 3]}``
    as numpy arrays or tensors. ``device`` defaults to the card and must be
    where the model lives. Returns ``(aux, xys [B, K, 3], keep [B, K])`` with
    ``aux["offset_clip_fraction"]``, the mean over encoder layers of the share
    of offsets the windowed clamp binds.
    """
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, eval_step asked for {dev}")

    imgs = torch.as_tensor(batch["imgs"], device=model_dev)
    affine_mats = torch.as_tensor(batch["affine_mats"], device=model_dev)
    ((world_heatmap, world_offset), _), clips = model(imgs, affine_mats)
    aux = {"offset_clip_fraction": torch.stack(clips).mean()} if clips else {}
    xys, keep = decode_detections(world_heatmap, world_offset, world_reduce, num_candidates, nms_dist)
    return aux, xys, keep
