"""Training and evaluation, port of ``mvdetr_tpu/train/trainer.py``.

- :func:`supervised_loss`: ``world_focal + world_off_l1 + (img_focal +
  img_off_l1 + 0.1 * img_wh_l1) / N * alpha`` (or the ``use_mse`` form).
- :func:`train_step`: forward in training mode (batch statistics, dropout
  from an explicit generator), the loss, backward (B2 and B3 on the card),
  the two-group Adam step and the OneCycle step.
- :func:`eval_step`: forward at inference -> sigmoid -> dense
  ``mvdet_decode`` -> top-K candidates -> per-sample greedy
  ``distance_nms``, plus the loss terms when the batch carries targets.
- :class:`Trainer`: the epoch loop over a ``FrameDataset`` (worker threads,
  batches uploaded ahead by :func:`~mvdetr_tpu_torch.data.prefetch.prefetch_to_device`),
  the CLEAR test (`trainer.py:99-169` of the original MVDeTr) with its
  ``--visualize`` figures, and the bitwise determinism check.

With a ``mesh`` (:mod:`mvdetr_tpu_torch.parallel`) each process is one rank
of the JAX package's sharded steps (`mvdetr_tpu/train/trainer.py:147-195,
272-360`): it loads its ``data`` coordinate's frames of every global batch,
its loss is its share of the global loss, the gradients are summed over
``data`` in rank order, and the test gathers every rank's detections, so
every rank reports the same loss and MODA.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Optional

import numpy as np
import torch

from mvdetr_tpu_torch import losses
from mvdetr_tpu_torch.data.prefetch import prefetch_to_device
from mvdetr_tpu_torch.device import resolve_device
from mvdetr_tpu_torch.evaluation import clear_metrics
from mvdetr_tpu_torch.models.layers import set_dropout_generator
from mvdetr_tpu_torch.models.world_feat.modules import _resize_bilinear
from mvdetr_tpu_torch.ops import distance_nms, mvdet_decode, top_k
from mvdetr_tpu_torch.parallel.collectives import (
    all_gather_list, check_replicated, group_size, reduce_gradients, reduce_sum,
)
from mvdetr_tpu_torch.parallel.mesh import DATA_VIEW
from mvdetr_tpu_torch.parallel.multihost import process_batch_slice
from mvdetr_tpu_torch.parallel.sharding import replicate_state, shard_cams
from mvdetr_tpu_torch.train.optim import schedule_step
from mvdetr_tpu_torch.utils.profiling import device_trace
from mvdetr_tpu_torch.utils.visualize import (
    STAGE_FIGURES, capture_attention, inference_outputs, matplotlib_pyplot, save_forward_stage_figures,
    shadow_backprojected, to_numpy,
)


def batch_to_device(batch: dict, device) -> dict:
    """The batch's arrays (numpy or tensors, nested one level for the
    targets) as tensors on ``device``; tensors already there are not copied."""
    def put(x):
        return {k: put(v) for k, v in x.items()} if isinstance(x, dict) else torch.as_tensor(x, device=device)

    return {k: put(v) for k, v in batch.items()}


def supervised_loss(outputs, batch: dict, alpha: float = 1.0, use_mse: bool = False, group=None, cam_group=None,
                    num_cam: Optional[int] = None, world_share: float = 1.0):
    """Compose the MVDeTr loss (`trainer.py:52-66` of the reference).
    ``outputs`` as the model returns them (NHWC); the batch's ``world_gt`` and
    ``imgs_gt`` as :func:`mvdetr_tpu_torch.data.build_targets` makes them,
    stacked. Returns ``(loss, aux)``. ``group``: the ``data`` axis's process
    group, over which every normaliser is taken (:mod:`mvdetr_tpu_torch.losses`):
    the loss is then this rank's share of the global batch's.

    On a mesh whose ``view`` axis splits the cameras (:func:`loss_axes`) the
    per-view terms are this rank's cameras', with their normalisers over
    ``cam_group`` (``("data", "view")``), the per-view sum is still divided
    by the global ``num_cam`` (not the batch's N / V cameras), and the BEV
    terms, which every view rank computes alike, enter ``loss`` with weight
    ``world_share = 1 / V``: the ranks' losses add up to the global loss.
    ``aux`` holds the terms unweighted.

    The per-view targets lie on the stride-8 grid of the input. A stride-16
    trunk (VGG-11) gives per-view head maps of half that size, against which
    the JAX loss fails to broadcast; here they are first resized to the
    targets' grid (bilinear, as ``jax.image.resize``)."""
    (world_heatmap, world_offset), (imgs_heatmap, imgs_offset, imgs_wh) = outputs
    wgt, igt = batch["world_gt"], batch["imgs_gt"]
    b, n = igt["heatmap"].shape[:2]
    grid = tuple(igt["heatmap"].shape[2:4])
    if tuple(imgs_heatmap.shape[1:3]) != grid:
        imgs_heatmap, imgs_offset, imgs_wh = (_resize_bilinear(x.permute(0, 3, 1, 2), grid).permute(0, 2, 3, 1)
                                              for x in (imgs_heatmap, imgs_offset, imgs_wh))

    def flat(x):  # [B, N, ...] -> [B*N, ...]
        return x.reshape((b * n,) + tuple(x.shape[2:]))

    cam_group = group if cam_group is None else cam_group
    num_cam = n if num_cam is None else num_cam

    def world(term):  # a BEV term's share on this view rank; exact for V a power of two
        return term if world_share == 1.0 else term * world_share

    if use_mse:
        loss = (world(losses.gaussian_mse_loss(world_heatmap, wgt["heatmap"], group))
                + alpha * losses.gaussian_mse_loss(imgs_heatmap, flat(igt["heatmap"]), cam_group))
        return loss, {"loss": loss}

    loss_w_hm = losses.focal_loss(world_heatmap, wgt["heatmap"], group=group)
    loss_w_off = losses.reg_l1_loss(world_offset, wgt["reg_mask"], wgt["idx"], wgt["offset"], group)
    loss_img_hm = losses.focal_loss(imgs_heatmap, flat(igt["heatmap"]), group=cam_group)
    loss_img_off = losses.reg_l1_loss(imgs_offset, flat(igt["reg_mask"]), flat(igt["idx"]), flat(igt["offset"]),
                                      cam_group)
    loss_img_wh = losses.reg_l1_loss(imgs_wh, flat(igt["reg_mask"]), flat(igt["idx"]), flat(igt["wh"]), cam_group)
    loss = world(loss_w_hm + loss_w_off) + (loss_img_hm + loss_img_off + 0.1 * loss_img_wh) / num_cam * alpha
    return loss, {"loss": loss, "w_hm": loss_w_hm, "w_off": loss_w_off, "img_hm": loss_img_hm,
                  "img_off": loss_img_off, "img_wh": loss_img_wh}


def loss_axes(model, mesh) -> dict:
    """The process groups and weights of :func:`supervised_loss` for
    ``model`` on ``mesh``: ``group`` the ``data`` axis's, ``cam_group`` the
    group of the per-view terms and of the gradients (``("data", "view")``
    where the model splits the cameras over ``view``, else ``data``'s),
    ``num_cam`` the global camera count, ``world_share`` 1 / V."""
    if mesh is None:
        return {}
    v = getattr(model, "view_shards", 1)
    return {"group": mesh.group("data"), "cam_group": mesh.group(DATA_VIEW) if v > 1 else mesh.group("data"),
            "num_cam": model.num_cam, "world_share": 1.0 / v}


WORLD_TERMS = ("w_hm", "w_off")  # the BEV loss terms, alike on every view rank


def global_aux(aux: dict, group, cam_group=None) -> dict:
    """The global batch's ``aux`` from every rank's: the loss terms (each
    rank's share) summed in rank order, the BEV terms over ``group`` (the
    ``data`` axis) and the rest over ``cam_group`` (default ``group``), and
    the ``offset_clip_fraction`` (each rank's mean over its queries) averaged
    over ``cam_group``."""
    cam_group = group if cam_group is None else cam_group
    if cam_group is None or not aux:
        return aux
    out = {}
    for g, keys in ((group, [k for k in sorted(aux) if k in WORLD_TERMS]),
                    (cam_group, [k for k in sorted(aux) if k not in WORLD_TERMS])):
        if keys:
            total = reduce_sum(torch.stack([aux[k].float() for k in keys]), g)
            out.update(zip(keys, total.unbind()))
    if "offset_clip_fraction" in out:
        out["offset_clip_fraction"] = out["offset_clip_fraction"] / group_size(cam_group)
    return {k: out[k] for k in aux}


def _model_device(model, device):
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"model is on {model_dev}, the step asked for {dev}")
    return model_dev


def train_step(state, batch: dict, generator: torch.Generator, alpha: float = 1.0, use_mse: bool = False,
               device="cuda", mesh=None):
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

    ``mesh``: this rank's step of the sharded step, on its block of the
    global batch (:func:`mvdetr_tpu_torch.parallel.sharding.make_sharded_train_step`):
    the loss normalisers and the gradients are summed over the ``data``
    axis, ``aux`` holds the global batch's values, and the step ends by
    checking that every rank holds the same parameters. Where the model
    splits the cameras over ``view`` the batch holds this rank's cameras,
    each rank's loss is its share of the global loss (:func:`supervised_loss`:
    the BEV terms at 1 / V), and every gradient is summed over ``("data",
    "view")``: with the camera gather's summed backward
    (:func:`~mvdetr_tpu_torch.parallel.collectives.gather_cams`) each
    parameter's applied gradient is the one-process step's.
    """
    model = state.model
    model_dev = _model_device(model, device)
    batch = batch_to_device(batch, model_dev)
    axes = loss_axes(model, mesh)
    was_training = model.training
    model.train()
    set_dropout_generator(model, generator)
    try:
        state.optimizer.zero_grad(set_to_none=True)
        outputs, clips = model(batch["imgs"], batch["affine_mats"])
        loss, aux = supervised_loss(outputs, batch, alpha, use_mse, **axes)
        loss.backward()
        reduce_gradients(model, axes.get("cam_group"))
        state.optimizer.step()
        schedule_step(state.scheduler)
        state.step += 1
    finally:
        set_dropout_generator(model, None)
        model.train(was_training)
    aux = {k: v.detach() for k, v in aux.items()}
    if clips:
        aux["offset_clip_fraction"] = torch.stack(clips).mean().detach()
    if mesh is not None:
        aux = global_aux(aux, axes["group"], axes["cam_group"])
        check_replicated(model, mesh.world_group)
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
              alpha: float = 1.0, use_mse: bool = False, device="cuda", mesh=None):
    """Serve one batch of frame sets, with the model in eval mode.

    ``batch``: ``{"imgs": [B, N, H, W, 3] uint8, "affine_mats": [B, N, 3, 3]}``
    as numpy arrays or tensors, and optionally ``world_gt`` and ``imgs_gt``.
    ``device`` defaults to the card and must be where the model lives.
    Returns ``(aux, xys [B, K, 3], keep [B, K])``: ``aux`` holds
    ``offset_clip_fraction`` (the mean over encoder layers of the share of
    offsets the windowed clamp binds) and, when the batch carries targets,
    the loss and its terms (`trainer.py:114`).

    ``mesh``: this rank's part of the sharded eval step, on its block of a
    global batch: ``aux`` holds the global batch's values and ``xys`` and
    ``keep`` every rank's blocks, gathered over ``data`` in rank order, so
    every rank returns the same outputs (the BEV heads run replicated over
    ``view`` and ``bev``).
    """
    model_dev = _model_device(model, device)
    batch = batch_to_device(batch, model_dev)
    was_training = model.training
    model.eval()
    try:
        outputs, clips = model(batch["imgs"], batch["affine_mats"])
    finally:
        model.train(was_training)
    axes = loss_axes(model, mesh)
    data_group = axes.get("group")
    aux = {}
    if "world_gt" in batch and "imgs_gt" in batch:
        aux = supervised_loss(outputs, batch, alpha, use_mse, **axes)[1]
    if clips:
        aux["offset_clip_fraction"] = torch.stack(clips).mean()
    (world_heatmap, world_offset), _ = outputs
    xys, keep = decode_detections(world_heatmap, world_offset, world_reduce, num_candidates, nms_dist)
    if mesh is not None:
        aux = global_aux(aux, data_group, axes["cam_group"])
    if data_group is not None:
        xys = torch.cat(all_gather_list(xys, data_group))
        keep = torch.cat(all_gather_list(keep.to(torch.uint8), data_group)).bool()  # gloo gathers no bool
    return aux, xys, keep


def detection_rows(xys: np.ndarray, keep: np.ndarray, frames, cls_thres: float, indexing_ij: bool):
    """Host side of the test loop on one batch of eval outputs (`trainer.py:
    121-135` of the original MVDeTr): the kept top-K candidates above
    ``cls_thres`` as rows ``[frame, x, y]``, the grid's (x, y) swapped to the
    dataset's native order on ij rigs. Returns ``(rows, cap_hits)``:
    ``cap_hits`` counts the frames whose every candidate cleared the
    threshold, where the top-K cap likely cut detections."""
    rows, cap_hits = [], 0
    for b in range(xys.shape[0]):
        above = xys[b, :, 2] > cls_thres
        cap_hits += int(above.all())
        pos = xys[b, keep[b] & above, :2]
        if indexing_ij:  # grid (x, y) -> dataset-native (`trainer.py:125-128`)
            pos = pos[:, [1, 0]]
        rows.extend([int(frames[b]), p[0], p[1]] for p in pos)
    return rows, cap_hits


class Trainer:
    """Epoch-level loop (host side): data iteration, logging, CLEAR eval.

    The model runs where ``state.model`` lives. Each train step draws its
    dropout masks from a ``torch.Generator`` on that device seeded from
    ``(seed, state.step)``, so a run resumed from a checkpoint draws the same
    masks as one that never stopped. ``profile_dir``: a ``torch.profiler``
    trace of steps 2-4 of epoch 1 (step 1 builds the kernels and warms the
    allocator) lands there.

    ``mesh``: this process's rank of a sharded run (the model built with the
    same mesh). The state is broadcast from rank 0, every rank loads its
    ``data`` coordinate's frames of each global batch and takes the sharded
    steps (:mod:`mvdetr_tpu_torch.parallel.sharding`), and the test gathers
    every rank's detections; only rank 0 writes ``res_fpath``. Every rank
    draws the same dropout generator, and its masks are its block of the
    one-process step's.
    """

    def __init__(self, state, dataset_train, dataset_test, cls_thres: float = 0.4, alpha: float = 1.0,
                 use_mse: bool = False, nms_top_k: int = 512, logger=print, num_workers: int = 0,
                 profile_dir: Optional[str] = None, seed: int = 2021, mesh=None):
        self.state = state
        self.train_set = dataset_train
        self.test_set = dataset_test
        self.cls_thres = cls_thres
        self.alpha = alpha
        self.use_mse = use_mse
        self.nms_top_k = nms_top_k
        self.log = logger
        self.num_workers = num_workers
        self.profile_dir = profile_dir
        self.seed = seed
        self.device = next(state.model.parameters()).device
        self.mesh = mesh
        self._figures_skipped = False
        if mesh is not None:
            replicate_state(state, mesh)

    def step_generator(self, step: int) -> torch.Generator:
        """The dropout generator of train step ``step``."""
        seed = int(np.random.SeedSequence([self.seed, step]).generate_state(1, np.uint64)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _host_batches(self, dataset, batch_size: int, **kwargs):
        """Worker-assembled host batches of ``dataset``: this rank's frames
        of each global batch, and its cameras (:func:`~mvdetr_tpu_torch.parallel.sharding.shard_cams`)."""
        it = dataset.batches(batch_size, num_workers=self.num_workers,
                             local_slice=process_batch_slice(batch_size, self.mesh), **kwargs)
        if self.mesh is None or self.mesh.shape["view"] == 1:
            return it

        def cams():
            try:
                for batch in it:
                    yield shard_cams(batch, self.mesh)
            finally:
                it.close()

        return cams()

    def _batches(self, batch_size: int):
        """This rank's block of each global train batch, uploaded ahead of
        the step."""
        return prefetch_to_device(self._host_batches(self.train_set, batch_size), self.device)

    def _train_step(self, batch):
        return train_step(self.state, batch, self.step_generator(self.state.step), self.alpha, self.use_mse,
                          device=self.device, mesh=self.mesh)

    def _eval_step(self, batch):
        return eval_step(self.state.model, batch, world_reduce=self.test_set.world_reduce,
                         num_candidates=self.nms_top_k, alpha=self.alpha, use_mse=self.use_mse, device=self.device,
                         mesh=self.mesh)

    def check_determinism(self, batch_size: int = 1) -> None:
        """Run the first train step twice from the same state, batch and
        generator and require bitwise-equal parameters (the original
        MVDeTr's ``--deterministic``, `main.py:43-46`); the state is put back
        afterwards. Guards against a nondeterministic kernel on the path."""
        batches = self._batches(batch_size)
        batch = next(batches)
        batches.close()
        state = self.state
        snap = (copy.deepcopy(state.model.state_dict()), copy.deepcopy(state.optimizer.state_dict()),
                copy.deepcopy(state.scheduler.state_dict()), state.step)

        def restore():
            state.model.load_state_dict(snap[0])
            # the optimizer keeps the tensors it is given and the step updates them in place
            state.optimizer.load_state_dict(copy.deepcopy(snap[1]))
            state.scheduler.load_state_dict(snap[2])
            state.step = snap[3]

        runs = []
        for _ in range(2):
            restore()
            self._train_step(batch)
            runs.append({n: p.detach().clone() for n, p in state.model.named_parameters()})
        restore()
        state.optimizer.zero_grad(set_to_none=True)
        bad = [n for n in runs[0] if not torch.equal(runs[0][n], runs[1][n])]
        if bad:
            raise RuntimeError(f"nondeterministic train step; first mismatching params: {bad[:5]}")
        self.log("determinism check passed: train step is bitwise reproducible")

    def train_epoch(self, epoch: int, batch_size: int = 1, log_interval: int = 100) -> float:
        t0 = time.time()
        losses_dev, count, aux = [], 0, {}  # device scalars; fetched only at log points
        with contextlib.ExitStack() as trace:
            profiling = False
            for batch in self._batches(batch_size):
                if self.profile_dir is not None and epoch == 1 and count == 1 and not profiling:
                    float(losses_dev[-1])  # barrier: trace only steady-state work
                    trace.enter_context(device_trace(self.profile_dir))
                    profiling = True
                self.state, aux = self._train_step(batch)
                losses_dev.append(aux["loss"])
                count += 1
                if profiling and count >= 4:
                    trace.close()  # synchronises, so the trace holds whole steps
                    profiling = False
                    self.log(f"profiler trace written to {self.profile_dir}")
                if count % log_interval == 0:
                    total = float(torch.stack(losses_dev).sum())
                    clip = (f", clip_frac {float(aux['offset_clip_fraction']):.4f}"
                            if "offset_clip_fraction" in aux else "")
                    self.log(f"Train epoch {epoch} batch {count}: loss {total / count:.6f}{clip}, "
                             f"t {time.time() - t0:.1f}s")
            if profiling:  # epoch shorter than the trace window
                trace.close()
                self.log(f"profiler trace written to {self.profile_dir}")
            elif self.profile_dir is not None and epoch == 1 and count < 2:
                self.log(f"NOTE: --profile requested but epoch 1 had only {count} batch(es) — "
                         "no trace was written (the window starts at batch 2)")
        total = float(torch.stack(losses_dev).sum()) if losses_dev else 0.0
        self.log(f"Train epoch {epoch} done: loss {total / max(count, 1):.6f}, t {time.time() - t0:.1f}s")
        if self.device.type == "cuda":
            self.log(f"Train epoch {epoch}: peak device memory "
                     f"{torch.cuda.max_memory_allocated(self.device) / 2**30:.2f} GiB")
        if count and "offset_clip_fraction" in aux:
            clip_frac = float(aux["offset_clip_fraction"])
            if clip_frac > 0.05:
                self.log(
                    f"WARNING: offset_clip_fraction {clip_frac:.3f} > 0.05 — the windowed "
                    f"attention clamp is starving learned offsets (accuracy risk). Raise "
                    f"--n_points to 8 (shadow refs, same fast path), or widen --attn_radius."
                )
        return total / max(count, 1)

    def test(self, batch_size: int = 1, res_fpath: Optional[str] = None, visualize_dir: Optional[str] = None):
        """Evaluate the test split: loss, detections (written to
        ``res_fpath`` as ``%d`` rows) and CLEAR ``(loss, moda, modp,
        precision, recall)``. On a mesh with a ``data`` axis each rank
        evaluates its frames of every full global batch and the ragged tail
        is padded with repeats of its last frame (`mvdetr_tpu/train/trainer.py:
        320-345`: the padded rows emit nothing, and the tail's loss, the mean
        over the padded batch, is weighted by the tail's share).

        ``visualize_dir``: the figures of the last test batch go there
        (:meth:`dump_figures`), in one process only, as in JAX."""
        t0 = time.time()
        total, count, aux = 0.0, 0, {}
        rows, cap_hits = [], 0
        indexing_ij = self.train_set.rig.indexing == "ij"

        def emit(xys, keep, frames):
            nonlocal rows, cap_hits
            new_rows, hits = detection_rows(xys.cpu().numpy(), keep.cpu().numpy(), frames, self.cls_thres,
                                            indexing_ij)
            rows += new_rows
            cap_hits += hits

        data = 1 if self.mesh is None else self.mesh.shape["data"]
        local = process_batch_slice(batch_size, self.mesh)
        host_batches = self._host_batches(self.test_set, batch_size, shuffle=False, drop_last=data > 1)
        frames = [int(f) for f in self.test_set.frames]
        last_batch = None
        for bi, batch in enumerate(prefetch_to_device(host_batches, self.device)):
            aux, xys, keep = self._eval_step(batch)
            total += float(aux["loss"])
            count += 1
            last_batch = batch
            emit(xys, keep, frames[bi * batch_size:(bi + 1) * batch_size] if data > 1 else np.asarray(batch["frame"]))
        tail = list(range(len(frames) - len(frames) % batch_size, len(frames))) if data > 1 else []
        if tail:
            from mvdetr_tpu_torch.data.dataset import collate

            padded = tail + [tail[-1]] * (batch_size - len(tail))
            batch = collate([self.test_set[i] for i in padded[local]])
            batch = batch_to_device(batch if self.mesh is None else shard_cams(batch, self.mesh), self.device)
            aux, xys, keep = self._eval_step(batch)
            total += float(aux["loss"]) * len(tail) / batch_size
            count += len(tail) / batch_size
            emit(xys[:len(tail)], keep[:len(tail)], [frames[i] for i in tail])

        if cap_hits:
            self.log(
                f"WARNING: eval top-K cap ({self.nms_top_k}) saturated on {cap_hits} frame(s) — "
                "detections may be truncated; raise --nms_top_k"
            )
        if count and "offset_clip_fraction" in aux:
            clip_frac = float(aux["offset_clip_fraction"])
            self.log(f"Eval offset_clip_fraction {clip_frac:.4f}")
            if clip_frac > 0.05:
                self.log(
                    "WARNING: >5% of attention offsets are clamped by the windowed radius "
                    "at eval — results may diverge from reference-exact semantics; raise --attn_radius."
                )
        det = np.asarray(rows, dtype=np.float64).reshape(-1, 3)
        if res_fpath is not None and (self.mesh is None or self.mesh.rank == 0):
            np.savetxt(res_fpath, det, "%d")
        if visualize_dir is not None and last_batch is not None and (self.mesh is None or self.mesh.world_group is None):
            self.dump_figures(last_batch, visualize_dir)
        gt = self.test_set.gt_array()
        # CLEAR matches on the integer-truncated rows as written to test.txt
        # via np.savetxt('%d') (`trainer.py:158-159`)
        recall, precision, moda, modp = clear_metrics(gt, np.floor(det) if len(det) else det)
        self.log(
            f"Test: loss {total / max(count, 1):.6f}, moda {moda:.1f}%, modp {modp:.1f}%, "
            f"prec {precision:.1f}%, recall {recall:.1f}%, t {time.time() - t0:.1f}s"
        )
        return total / max(count, 1), moda, modp, precision, recall

    FIGURES = ("world.jpg", "cam1_foot.jpg") + STAGE_FIGURES + ("shadow_points.jpg",)

    def dump_figures(self, batch, out_dir: str) -> list:
        """The ``--visualize`` figures of ``batch`` (`mvdetr_tpu/train/trainer.py:
        398-468`): ``world.jpg`` (the predicted BEV heatmap over the target),
        ``cam1_foot.jpg`` (the first camera's foot heatmap), the per-stage
        figures (:func:`~mvdetr_tpu_torch.utils.visualize.save_forward_stage_figures`)
        and ``shadow_points.jpg`` (:meth:`_dump_shadow_figure`). Returns the
        paths written. Without matplotlib it writes none and logs, once per
        trainer, one line saying so (JAX returns silently)."""
        plt = matplotlib_pyplot()
        if plt is None:
            if not self._figures_skipped:
                self.log(f"NOTE: --visualize skipped {', '.join(self.FIGURES)}: matplotlib is not installed")
            self._figures_skipped = True
            return []
        os.makedirs(out_dir, exist_ok=True)
        (world_heatmap, _), (imgs_heatmap, _, _) = inference_outputs(self.state.model, batch)
        fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(10, 6))
        ax0.set_title("output")
        ax0.imshow(to_numpy(torch.sigmoid(world_heatmap))[0, :, :, 0])
        ax1.set_title("target")
        ax1.imshow(to_numpy(torch.as_tensor(batch["world_gt"]["heatmap"]))[0, :, :, 0])
        paths = [os.path.join(out_dir, "world.jpg")]
        fig.savefig(paths[-1])
        plt.close(fig)
        fig, ax = plt.subplots()
        ax.imshow(to_numpy(torch.sigmoid(imgs_heatmap))[0, :, :, 0])
        ax.set_title("cam1 foot heatmap")
        paths.append(os.path.join(out_dir, "cam1_foot.jpg"))
        fig.savefig(paths[-1])
        plt.close(fig)
        paths += save_forward_stage_figures(self.state.model, batch, out_dir)
        paths += self._dump_shadow_figure(batch, out_dir, plt)
        return paths

    def _dump_shadow_figure(self, batch, out_dir: str, plt) -> list:
        """The attended points of the last encoder layer for the strongest
        BEV query, per camera, over the predicted heatmap (the paper's shadow
        figure, `deform_visualize.py:44-139` of the original MVDeTr). None
        for a model without deformable attention."""
        outputs, layers = capture_attention(self.state.model, batch)
        if not layers:
            return []
        (world_heatmap, _), _ = outputs
        hm = to_numpy(torch.sigmoid(world_heatmap))[0, :, :, 0]
        hs2, ws2 = (v // 2 for v in self.train_set.Rworld_shape)
        # the strongest BEV cell, snapped to the stride-2 query grid; its query in the first camera's block
        y, x = np.unravel_index(np.argmax(hm), hm.shape)
        qy, qx = min(int(y) // 2, hs2 - 1), min(int(x) // 2, ws2 - 1)
        bev, _ = shadow_backprojected(self.train_set.rig, layers[-1]["sampling_locations"][0],
                                      layers[-1]["attention_weights"][0], qy * ws2 + qx,
                                      world_reduce=self.train_set.world_reduce, downsample=2)
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.imshow(hm, cmap="gray")
        colors = plt.cm.tab10(np.linspace(0, 1, len(bev)))
        for cam, (pts, wts) in bev.items():
            sel = wts > wts.max() * 0.1 if len(wts) else slice(None)
            ax.scatter(pts[sel, 0] * 2, pts[sel, 1] * 2, s=40 * wts[sel] / (wts.max() + 1e-8),
                       color=colors[cam], label=f"cam{cam + 1}", alpha=0.7)
        ax.scatter([qx * 2], [qy * 2], marker="x", color="red", s=80)
        ax.legend(fontsize=6)
        ax.set_title("shadow attention (last layer, strongest query)")
        path = os.path.join(out_dir, "shadow_points.jpg")
        fig.savefig(path)
        plt.close(fig)
        return [path]
