"""Collectives of the mesh's axes, each with a fixed summation order.

JAX's SPMD programs get these from XLA; the port writes them on
``torch.distributed`` (gloo on the CPU, NCCL on GPUs). Every sum is taken by
gathering the ranks' parts and adding them in rank order, so a step gives
the same bits on every rank and repeats bitwise from run to run, whatever
the backend's own reduction order:

- :func:`all_reduce_sum`: differentiable, its backward the same all-reduce
  of the cotangents (the statistics of a BatchNorm over the ``data`` axis);
  :func:`reduce_sum` the same without autograd;
- :func:`halo_exchange`: the ``+-R`` rows of the neighbouring BEV shards
  (`mvdetr_tpu/ops/msda_sharded.py:52-59`), their gradient sent back;
- :func:`gather_rows` and :func:`take_rows`: a shard's row block to the full
  map and back;
- :func:`gather_cams`: every view rank's camera block to all cameras, with
  the backward that sums the ranks' cotangents (the camera-sharded model's
  one collective, `mvdetr_tpu/parallel/sharding.py:1-17`);
- :func:`reduce_gradients` and :func:`check_replicated`: the data-parallel
  step's gradient sum and its check that every rank holds the same
  parameters afterwards.

A ``group`` of None stands for a one-process axis without a process group:
every function is then the identity on its input.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather_list(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (same shape on all), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``, added in rank order (the same bits on
    every rank); no autograd."""
    if group is None:
        return x
    parts = all_gather_list(x.detach(), group)
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        # every rank's output is the same sum of every rank's input
        return reduce_sum(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`reduce_sum` under autograd: the cotangent of each rank's input
    is the sum of every rank's output cotangent (SyncBatchNorm's rule)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def _rows(x: torch.Tensor, dim: int, start: int, length: int) -> torch.Tensor:
    return x.narrow(dim, start, length).contiguous()


def _exchange(sends: dict, recvs: dict, group) -> None:
    """Post every send and receive to the group ranks that key them, then
    wait for all."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group) for peer, t in sends.items()]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer), group) for peer, t in recvs.items()]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, group, radius, dim):
        j, n = group_rank(group), group_size(group)
        ctx.group, ctx.radius, ctx.dim = group, radius, dim
        rows = v.shape[dim]
        shape = list(v.shape)
        shape[dim] = radius
        top, bottom = v.new_zeros(shape), v.new_zeros(shape)  # an edge shard's halo stays zero
        sends, recvs = {}, {}
        if j > 0:  # my first R rows are shard j-1's bottom halo; its last R rows my top halo
            sends[j - 1], recvs[j - 1] = _rows(v, dim, 0, radius), top
        if j < n - 1:
            sends[j + 1], recvs[j + 1] = _rows(v, dim, rows - radius, radius), bottom
        _exchange(sends, recvs, group)
        return torch.cat([top, v, bottom], dim)

    @staticmethod
    def backward(ctx, g):
        group, r, dim = ctx.group, ctx.radius, ctx.dim
        j, n = group_rank(group), group_size(group)
        rows = g.shape[dim] - 2 * r
        inner = _rows(g, dim, r, rows)
        sends, recvs = {}, {}
        if j > 0:  # my top halo's gradient belongs to shard j-1's last rows, and its bottom halo's to my first
            sends[j - 1], recvs[j - 1] = _rows(g, dim, 0, r), torch.empty_like(_rows(g, dim, 0, r))
        if j < n - 1:
            sends[j + 1], recvs[j + 1] = _rows(g, dim, r + rows, r), torch.empty_like(_rows(g, dim, 0, r))
        _exchange(sends, recvs, group)
        if j > 0:
            inner.narrow(dim, 0, r).add_(recvs[j - 1])
        if j < n - 1:
            inner.narrow(dim, rows - r, r).add_(recvs[j + 1])
        return inner, None, None, None


def halo_exchange(v: torch.Tensor, group, radius: int, dim: int = 2) -> torch.Tensor:
    """This BEV shard's rows with ``radius`` rows of each neighbour around
    them along ``dim``: shard j's last R rows become shard j+1's top halo,
    its first R rows shard j-1's bottom halo, and the edge shards' outer
    halos are zeros, the unsharded map's zero padding. Needs at least R rows
    a shard. The backward adds each halo row's gradient to the row it came
    from, in a fixed order: the shard's own gradient, then that of shard j-1's
    bottom halo, then that of shard j+1's top halo (one ``batch_isend_irecv``
    each way)."""
    if group is None:
        raise ValueError("halo_exchange needs the bev axis's process group")
    if v.shape[dim] < radius:
        raise ValueError(f"halo_exchange: a shard of {v.shape[dim]} rows is thinner than the halo of {radius}")
    return _HaloExchange.apply(v, group, int(radius), dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.rows = group, dim, x.shape[dim]
        return torch.cat(all_gather_list(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        # Everything after the gather runs replicated on every rank, so the
        # cotangents that arrive are the same on all: this rank's block is its
        # input's gradient. Summing them over the ranks would scale it by N.
        return _rows(g, ctx.dim, group_rank(ctx.group) * ctx.rows, ctx.rows), None, None


def gather_rows(x: torch.Tensor, group, dim: int = 2) -> torch.Tensor:
    """The full map from every rank's row block along ``dim``, in rank order;
    the backward takes this rank's block of the (replicated) cotangent."""
    return x if group is None else _GatherRows.apply(x, group, dim)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = group_size(group)
        ctx.group, ctx.dim = group, dim
        rows = x.shape[dim] // n
        return _rows(x, dim, group_rank(group) * rows, rows)

    @staticmethod
    def backward(ctx, g):
        # each row of the replicated input reaches one rank's block only, so
        # the gathered blocks are the all-reduced gradient, exactly
        return torch.cat(all_gather_list(g, ctx.group), ctx.dim), None, None


def take_rows(x: torch.Tensor, group, dim: int = 2) -> torch.Tensor:
    """This rank's block of ``x``'s rows along ``dim`` (``x`` replicated on
    every rank, its rows divisible by the group's size). The backward gives
    every rank the full gradient of ``x``: the ranks' block gradients,
    gathered in rank order."""
    if group is None:
        return x
    if x.shape[dim] % group_size(group):
        raise ValueError(f"take_rows: {x.shape[dim]} rows do not divide into {group_size(group)} shards")
    return _TakeRows.apply(x, group, dim)


class _GatherCams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.rows = group, dim, x.shape[dim]
        return torch.cat(all_gather_list(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        # every rank consumes all blocks, each in its own way (its query blocks, or its share of the loss): the
        # gradient of this rank's block is the sum of every rank's cotangent of it, in rank order
        return _rows(reduce_sum(g, ctx.group), ctx.dim, group_rank(ctx.group) * ctx.rows, ctx.rows), None, None


def gather_cams(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """All cameras from every view rank's block along ``dim``, in rank order.
    The backward sums the cotangents of every rank in rank order and takes
    this rank's block: each rank's consumers differ (the encoder's value,
    sampled from each rank's own query blocks), or each rank's loss is its
    share of the global loss (the replicated part after the last gather).

    :func:`gather_rows` is the same gather with the other backward (this
    rank's block of a cotangent the ranks hold equal); the camera-sharded
    model needs only this one, since every rank's loss is its share of the
    global loss (``train/trainer.py``). The sum gathers every rank's whole
    cotangent: each rank receives V - 1 of them for the 1 / V it keeps."""
    return x if group is None else _GatherCams.apply(x, group, dim)


def reduce_gradients(module: torch.nn.Module, group) -> None:
    """Replace every parameter gradient of ``module`` by its sum over
    ``group``, added in rank order (one gather of all gradients, flattened).
    Parameters without a gradient keep none; every rank has the same
    ones, since every rank runs the same graph."""
    if group is None:
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def checksum(module: torch.nn.Module) -> torch.Tensor:
    """An int64 sum of the bit patterns of ``module``'s parameters and
    buffers (f32 read as int32), one cheap fingerprint of their bits."""
    total = torch.zeros((), dtype=torch.int64, device=next(module.parameters()).device)
    for t in list(module.parameters()) + list(module.buffers()):
        if t.dtype == torch.float32:
            total += t.detach().contiguous().view(torch.int32).sum(dtype=torch.int64)
    return total


def check_replicated(module: torch.nn.Module, group) -> None:
    """Raise unless every rank of ``group`` holds ``module`` with the same
    :func:`checksum` (a synchronising read of one int64 per rank)."""
    if group is None:
        return
    sums = [int(s) for s in all_gather_list(checksum(module).reshape(1), group)]
    if len(set(sums)) != 1:
        raise RuntimeError(f"ranks hold different parameters after the step: checksums {sums}")
