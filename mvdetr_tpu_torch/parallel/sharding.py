"""The sharded steps, port of ``mvdetr_tpu/parallel/sharding.py``.

JAX replicates the train state over the mesh, shards each batch's frame axis
over ``data`` and lets XLA insert the collectives. In the port each process
holds a replica and its frames:

- :func:`replicate_state`: rank 0's parameters, BatchNorm statistics and
  optimizer state, broadcast to every rank;
- :func:`shard_batch`: this rank's block of a global batch, JAX's
  ``batch_shardings``: the frame axis over ``data``, then the camera axis of
  ``imgs``, ``affine_mats`` and every ``imgs_gt`` array over ``view``
  (:func:`shard_cams`; ``world_gt`` has no camera axis);
- :func:`make_sharded_train_step` and :func:`make_sharded_eval_step`: the
  steps of :mod:`mvdetr_tpu_torch.train.trainer` on the mesh. The train step
  sums the loss normalisers, the BatchNorm statistics (in the model, bound
  by ``MVDeTr.from_rig(mesh=...)``) and the gradients over ``data`` (and
  ``view``) in rank order, and checks that every rank ends the step with the
  same parameters.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from mvdetr_tpu_torch.parallel.mesh import view_shards
from mvdetr_tpu_torch.parallel.multihost import process_batch_slice

CAMERA_KEYS = ("imgs", "affine_mats", "imgs_gt")  # the batch entries with a camera axis (axis 1)


def replicate_state(state, mesh) -> None:
    """Broadcast rank 0's model (parameters and buffers), optimizer state and
    step count to every rank of ``mesh``, in place (through the model's
    device: NCCL moves CUDA tensors only). A no-op without a process group."""
    group = mesh.world_group
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    device = next(state.model.parameters()).device
    tensors = list(state.model.state_dict().values())
    for per_param in state.optimizer.state.values():
        tensors += [v for _, v in sorted(per_param.items()) if torch.is_tensor(v)]
    step = torch.tensor([state.step], dtype=torch.int64)
    with torch.no_grad():
        for t in tensors + [step]:
            moved = t.to(device)
            dist.broadcast(moved, src, group=group)
            if moved is not t:
                t.copy_(moved)
    state.step = int(step)


def _cut(x, index):
    return {k: _cut(v, index) for k, v in x.items()} if isinstance(x, dict) else x[index]


def shard_cams(batch: dict, mesh) -> dict:
    """This rank's cameras of a batch (any frames): the camera axis of
    ``imgs``, ``affine_mats`` and the ``imgs_gt`` arrays cut to the block of
    its ``view`` coordinate; the batch as it is where the axis is idle
    (:func:`~mvdetr_tpu_torch.parallel.mesh.view_shards`)."""
    if mesh is None or mesh.shape["view"] == 1:
        return batch
    n = batch["imgs"].shape[1]
    v = view_shards(mesh, n)
    if v == 1:
        return batch
    per = n // v
    cams = (slice(None), slice(mesh.index("view") * per, (mesh.index("view") + 1) * per))
    return {k: _cut(x, cams) if k in CAMERA_KEYS else x for k, x in batch.items()}


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's block of every array of a global ``batch``: the frame axis
    over ``data`` (the targets' dicts likewise), then the cameras over
    ``view`` (:func:`shard_cams`)."""
    return shard_cams(_cut(batch, process_batch_slice(len(batch["imgs"]), mesh)), mesh)


def make_sharded_train_step(mesh, alpha: float = 1.0, use_mse: bool = False):
    """``step(state, batch, generator, device=...) -> (state, aux)`` on this
    rank's block of the global batch (see :func:`~mvdetr_tpu_torch.train.trainer.train_step`)."""
    from mvdetr_tpu_torch.train.trainer import train_step

    return functools.partial(train_step, alpha=alpha, use_mse=use_mse, mesh=mesh)


def make_sharded_eval_step(mesh, world_reduce: int = 4, num_candidates: int = 512, alpha: float = 1.0,
                           use_mse: bool = False):
    """``step(model, batch, device=...) -> (aux, xys, keep)`` of the global
    batch from this rank's block of it (see :func:`~mvdetr_tpu_torch.train.trainer.eval_step`)."""
    from mvdetr_tpu_torch.train.trainer import eval_step

    return functools.partial(eval_step, world_reduce=world_reduce, num_candidates=num_candidates, alpha=alpha,
                             use_mse=use_mse, mesh=mesh)
