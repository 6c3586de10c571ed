"""The process mesh, port of ``mvdetr_tpu/parallel/mesh.py``.

The JAX package lays its devices out on a 3-axis logical mesh:

- ``data``: batch (frame-set) parallelism; gradients, BatchNorm statistics
  and the loss's normalisers are summed over it;
- ``view``: camera sharding: each rank runs the trunk, the per-view heads
  and the warp on its block of the cameras, and the windowed encoder on
  their query blocks (:func:`view_shards`);
- ``bev``: BEV-row sharding of the deformable encoder, with a ``+-radius``
  halo exchange (:mod:`mvdetr_tpu_torch.ops.msda_sharded`).

In the port each ``torch.distributed`` process drives one device, so the mesh
lays the processes' ranks out as (data, view, bev), rank-major as JAX's
``reshape`` of its device list, and holds the process group of each axis
slice that this rank belongs to, for the axes longer than 1, and of its
``("data", "view")`` slice (the ranks that share its ``bev`` index: the
``[B*N]`` axis that JAX shards with ``P(("data", "view"))``). A one-rank
slice, and every slice of a one-process mesh, has no group (None), and every
collective of :mod:`mvdetr_tpu_torch.parallel.collectives` over it is the
identity.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist

AXES = ("data", "view", "bev")
DATA_VIEW = ("data", "view")


class Mesh:
    """This rank's place on the (data, view, bev) process mesh.

    ``shape`` is a dict as in JAX (``{"data": d, "view": v, "bev": n}``);
    :meth:`index` is this rank's coordinate on an axis and :meth:`group` the
    process group of the ranks that differ from it only there (None for an
    axis of one rank), or, for ``("data", "view")``, only on those two axes.
    ``world_group`` spans every rank of the mesh (None for one process)."""

    def __init__(self, shape: dict, rank: int, coords: dict, groups: dict, world_group=None):
        self.shape = dict(shape)
        self.rank = rank
        self._coords = dict(coords)
        self._groups = dict(groups)
        self.world_group = world_group

    def index(self, axis: str) -> int:
        return self._coords[axis]

    def group(self, axis):
        return self._groups.get(tuple(axis) if isinstance(axis, (tuple, list)) else axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self._coords})"


def rank_grid(world_size: int, num_view_shards: int = 1, num_bev_shards: int = 1) -> np.ndarray:
    """The ranks of ``world_size`` processes laid out as ``[data, view,
    bev]``, rank-major (JAX's ``reshape`` of its device list)."""
    per = num_view_shards * num_bev_shards
    if world_size % per:
        raise ValueError(f"{world_size} processes not divisible into {num_view_shards} view x "
                         f"{num_bev_shards} bev shards")
    return np.arange(world_size).reshape(world_size // per, num_view_shards, num_bev_shards)


def make_mesh(num_view_shards: int = 1, num_bev_shards: int = 1, world_size: Optional[int] = None) -> Mesh:
    """A (data, view, bev) mesh over ``world_size`` processes (default: every
    process of ``torch.distributed``, or 1 without it): ``num_bev_shards``
    must divide the world and, for the sharded attention, the encoder's BEV
    rows; ``num_view_shards`` the world and, for the cameras to be split, the
    camera count (:func:`view_shards`); the remaining processes form the data
    axis.

    Every process must call this with the same arguments: it creates one
    group per slice of each axis longer than 1, then one per ``("data",
    "view")`` slice of more than one rank (``torch.distributed`` requires
    every process to create every group, in the same order)."""
    if num_view_shards < 1 or num_bev_shards < 1:
        raise ValueError(f"shard counts must be >= 1, got view {num_view_shards}, bev {num_bev_shards}")
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    world_size = world if world_size is None else int(world_size)
    if world_size != world:
        raise ValueError(f"a mesh of {world_size} processes needs as many torch.distributed processes; "
                         f"there are {world} (start them with initialize_distributed)")
    grid = rank_grid(world_size, num_view_shards, num_bev_shards)
    rank = dist.get_rank() if initialized else 0
    where = tuple(int(i) for i in np.argwhere(grid == rank)[0])
    coords = dict(zip(AXES, where))
    groups = {}
    if initialized:
        for ax, axis in enumerate(AXES):
            if grid.shape[ax] == 1:  # a one-rank axis needs no collective: its group stays None
                continue
            lines = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[axis] = group
        if grid.shape[0] * grid.shape[1] > 1:
            for bev in range(grid.shape[2]):
                members = [int(r) for r in grid[:, :, bev].reshape(-1)]
                group = dist.new_group(members)
                if rank in members:
                    groups[DATA_VIEW] = group
    shape = dict(zip(AXES, grid.shape))
    return Mesh(shape, rank, coords, groups, dist.group.WORLD if world_size > 1 else None)


def view_shards(mesh, num_cam: int) -> int:
    """The camera shards of ``mesh``'s ``view`` axis for a rig of ``num_cam``
    cameras: the axis's size where it divides the cameras, else 1. As JAX's
    ``_constrain`` (`mvdetr_tpu/models/mvdetr.py:222-242`), an axis that does
    not divide the cameras is idle: every view rank runs every camera, and
    nothing is summed over it."""
    v = 1 if mesh is None else mesh.shape["view"]
    return v if v > 1 and num_cam % v == 0 else 1
