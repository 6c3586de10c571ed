"""Several processes, port of ``mvdetr_tpu/parallel/multihost.py``.

JAX's multi-host recipe becomes ``torch.distributed``: each process drives
one device (gloo on the CPU, NCCL on GPUs, one GPU per process), joins the
others through a TCP store at the coordinator's ``host:port``, and loads only
the frames of its ``data`` coordinate (:func:`process_batch_slice`).
"""

from __future__ import annotations

import datetime
import socket
from typing import Optional

import torch
import torch.distributed as dist

from mvdetr_tpu_torch.device import resolve_device


def check_processes_per_host(hosts: list) -> None:
    """``hosts``: ``(hostname, GPU count)`` of every rank. Raise unless every
    host has at least one GPU per process on it (NCCL refuses two ranks on
    one GPU)."""
    for host in sorted({h for h, _ in hosts}):
        ranks = [r for r, (h, _) in enumerate(hosts) if h == host]
        gpus = hosts[ranks[0]][1]
        if len(ranks) > gpus:
            raise RuntimeError(f"{len(ranks)} processes (ranks {ranks}) on host {host!r}, which has {gpus} GPU(s): "
                               f"NCCL takes one GPU per process")


def initialize_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           timeout: datetime.timedelta = datetime.timedelta(minutes=5)) -> Optional[torch.device]:
    """Join ``num_processes`` processes as rank ``process_id`` through the TCP
    store at ``coordinator_address`` (``host:port``, served by rank 0): gloo
    for ``device="cpu"``, NCCL for ``"cuda"``, where rank i takes
    ``cuda:{i % device_count}``. Returns this process's device, or None for
    one process (a no-op, as in JAX). Idempotent: a second call with the
    same world size returns the device again.

    Under ``cuda`` every rank first publishes its host name and GPU count in
    the store, and every rank raises before any work when a host has more
    processes than GPUs."""
    if num_processes is None or num_processes <= 1:
        return None
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise RuntimeError(f"torch.distributed already runs {dist.get_world_size()} processes, "
                               f"not {num_processes}")
        return _rank_device(dev, dist.get_rank())
    if coordinator_address is None or process_id is None:
        raise ValueError(f"--num_processes {num_processes} needs --process_id and --coordinator_address host:port")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is not in [0, {num_processes})")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--coordinator_address must be host:port, got {coordinator_address!r}")
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0, timeout=timeout)
    if dev.type == "cuda":
        store.set(f"mvdetr_host/{process_id}", f"{torch.cuda.device_count()} {socket.gethostname()}")
        hosts = []
        for r in range(num_processes):
            count, name = store.get(f"mvdetr_host/{r}").decode().split(" ", 1)
            hosts.append((name, int(count)))
        check_processes_per_host(hosts)
        torch.cuda.set_device(_rank_device(dev, process_id))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    return _rank_device(dev, process_id)


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    return torch.device("cuda", rank % torch.cuda.device_count()) if dev.type == "cuda" else dev


def process_batch_slice(total_batch: int, mesh=None) -> slice:
    """The frame rows of a global batch of ``total_batch`` that this process
    loads: the block of its ``data`` coordinate, or every row on a mesh
    without a data axis (a ``bev``-sharded process computes the whole batch).
    One device per process owns one row of the data axis, so JAX's check that
    a process's rows are contiguous holds by construction."""
    data = 1 if mesh is None else mesh.shape["data"]
    if data <= 1:
        return slice(0, total_batch)
    if total_batch % data:
        raise ValueError(f"a global batch of {total_batch} does not divide over data={data}")
    per = total_batch // data
    start = mesh.index("data") * per
    return slice(start, start + per)
