"""Training and serving steps, port of ``mvdetr_tpu/train/trainer.py:31-131``.

- :func:`supervised_loss`: ``world_focal + world_off_l1 + (img_focal +
  img_off_l1 + 0.1 * img_wh_l1) / N * alpha`` (or the ``use_mse`` form).
- :func:`train_step`: forward in training mode (batch statistics, dropout
  from an explicit generator), the loss, backward (B2 and B3 on the card),
  the two-group Adam step and the OneCycle step.
- :func:`eval_step`: forward at inference -> sigmoid -> dense
  ``mvdet_decode`` -> top-K candidates -> per-sample greedy
  ``distance_nms``, plus the loss terms when the batch carries targets.

The epoch loop, ``check_determinism``, checkpoints and the CLI wait for
ROADMAP item A7.
"""

from __future__ import annotations

import torch

from mvdetr_tpu_torch import losses
from mvdetr_tpu_torch.device import resolve_device
from mvdetr_tpu_torch.models.layers import set_dropout_generator
from mvdetr_tpu_torch.ops import distance_nms, mvdet_decode, top_k
from mvdetr_tpu_torch.train.optim import schedule_step


def batch_to_device(batch: dict, device) -> dict:
    """The batch's arrays (numpy or tensors, nested one level for the
    targets) as tensors on ``device``; tensors already there are not copied."""
    def put(x):
        return {k: put(v) for k, v in x.items()} if isinstance(x, dict) else torch.as_tensor(x, device=device)

    return {k: put(v) for k, v in batch.items()}


def supervised_loss(outputs, batch: dict, alpha: float = 1.0, use_mse: bool = False):
    """Compose the MVDeTr loss (`trainer.py:52-66` of the reference).
    ``outputs`` as the model returns them (NHWC); the batch's ``world_gt`` and
    ``imgs_gt`` as :func:`mvdetr_tpu_torch.data.build_targets` makes them,
    stacked. Returns ``(loss, aux)``."""
    (world_heatmap, world_offset), (imgs_heatmap, imgs_offset, imgs_wh) = outputs
    wgt, igt = batch["world_gt"], batch["imgs_gt"]
    b, n = igt["heatmap"].shape[:2]

    def flat(x):  # [B, N, ...] -> [B*N, ...]
        return x.reshape((b * n,) + tuple(x.shape[2:]))

    if use_mse:
        loss = (losses.gaussian_mse_loss(world_heatmap, wgt["heatmap"])
                + alpha * losses.gaussian_mse_loss(imgs_heatmap, flat(igt["heatmap"])))
        return loss, {"loss": loss}

    loss_w_hm = losses.focal_loss(world_heatmap, wgt["heatmap"])
    loss_w_off = losses.reg_l1_loss(world_offset, wgt["reg_mask"], wgt["idx"], wgt["offset"])
    loss_img_hm = losses.focal_loss(imgs_heatmap, flat(igt["heatmap"]))
    loss_img_off = losses.reg_l1_loss(imgs_offset, flat(igt["reg_mask"]), flat(igt["idx"]), flat(igt["offset"]))
    loss_img_wh = losses.reg_l1_loss(imgs_wh, flat(igt["reg_mask"]), flat(igt["idx"]), flat(igt["wh"]))
    loss = loss_w_hm + loss_w_off + (loss_img_hm + loss_img_off + 0.1 * loss_img_wh) / n * alpha
    return loss, {"loss": loss, "w_hm": loss_w_hm, "w_off": loss_w_off, "img_hm": loss_img_hm,
                  "img_off": loss_img_off, "img_wh": loss_img_wh}


def _model_device(model, device):
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, the step asked for {dev}")
    return model_dev


def train_step(state, batch: dict, generator: torch.Generator, alpha: float = 1.0, use_mse: bool = False,
               device="cuda"):
    """One training step; returns ``(state, aux)``.

    ``state`` is a :class:`~mvdetr_tpu_torch.train.state.TrainState`, updated
    in place: parameters, optimizer moments, BatchNorm running statistics,
    schedule and ``step``. The gradients stay in the parameters' ``.grad``
    until the next step. ``batch`` holds ``imgs [B, N, H, W, 3]`` uint8,
    ``affine_mats [B, N, 3, 3]``, ``world_gt`` and ``imgs_gt`` (numpy or
    tensors). Dropout masks come from ``generator``, which must live on the
    model's device. ``device`` defaults to the card and must be where the
    model lives. ``aux`` holds the loss, its five terms and the mean
    ``offset_clip_fraction`` of the encoder layers, as device scalars.
    """
    model = state.model
    model_dev = _model_device(model, device)
    batch = batch_to_device(batch, model_dev)
    was_training = model.training
    model.train()
    set_dropout_generator(model, generator)
    try:
        state.optimizer.zero_grad(set_to_none=True)
        outputs, clips = model(batch["imgs"], batch["affine_mats"])
        loss, aux = supervised_loss(outputs, batch, alpha, use_mse)
        loss.backward()
        state.optimizer.step()
        schedule_step(state.scheduler)
        state.step += 1
    finally:
        set_dropout_generator(model, None)
        model.train(was_training)
    aux = {k: v.detach() for k, v in aux.items()}
    if clips:
        aux["offset_clip_fraction"] = torch.stack(clips).mean().detach()
    return state, aux


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
              alpha: float = 1.0, use_mse: bool = False, device="cuda"):
    """Serve one batch of frame sets, with the model in eval mode.

    ``batch``: ``{"imgs": [B, N, H, W, 3] uint8, "affine_mats": [B, N, 3, 3]}``
    as numpy arrays or tensors, and optionally ``world_gt`` and ``imgs_gt``.
    ``device`` defaults to the card and must be where the model lives.
    Returns ``(aux, xys [B, K, 3], keep [B, K])``: ``aux`` holds
    ``offset_clip_fraction`` (the mean over encoder layers of the share of
    offsets the windowed clamp binds) and, when the batch carries targets,
    the loss and its terms (`trainer.py:114`).
    """
    model_dev = _model_device(model, device)
    batch = batch_to_device(batch, model_dev)
    was_training = model.training
    model.eval()
    try:
        outputs, clips = model(batch["imgs"], batch["affine_mats"])
    finally:
        model.train(was_training)
    aux = {}
    if "world_gt" in batch and "imgs_gt" in batch:
        aux = supervised_loss(outputs, batch, alpha, use_mse)[1]
    if clips:
        aux["offset_clip_fraction"] = torch.stack(clips).mean()
    (world_heatmap, world_offset), _ = outputs
    xys, keep = decode_detections(world_heatmap, world_offset, world_reduce, num_candidates, nms_dist)
    return aux, xys, keep
