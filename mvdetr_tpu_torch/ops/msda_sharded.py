"""BEV-row-sharded windowed attention, port of ``mvdetr_tpu/ops/msda_sharded.py``.

For BEV grids too large for one device, the query and value rows (the H
axis) are split over the mesh's ``bev`` axis, and only the ``+-radius`` halo
rows move between neighbouring shards. Each process of the ``bev`` group:

1. takes its row block of the value, offsets and weights, which every rank
   holds whole (:func:`~mvdetr_tpu_torch.parallel.collectives.take_rows`;
   its backward gives every rank the full gradients);
2. gets ``radius`` rows of each neighbour around its value block
   (:func:`~mvdetr_tpu_torch.parallel.collectives.halo_exchange`; the edge
   shards' outer halos are zeros, the unsharded map's zero padding);
3. runs :func:`local`, the windowed attention in ``row_halo`` mode (B1 and
   B2 on the card);
4. gathers the output's row blocks in rank order
   (:func:`~mvdetr_tpu_torch.parallel.collectives.gather_rows`), so that
   everything after the attention runs replicated.

:func:`compose_bev_shards` runs the same shards one after another in one
process, with each halo cut from the full map, which is what the exchange
delivers: its forward gives the unsharded attention's bits, and the tests
and ``chip_smoke.py`` hold the kernels' halo mode against the unsharded
kernels with it.
"""

from __future__ import annotations

import torch

from mvdetr_tpu_torch.ops.msda_windowed import windowed_attention
from mvdetr_tpu_torch.parallel.collectives import gather_rows, group_size, halo_exchange, take_rows


def check_bev_shards(h: int, n: int, radius: int) -> None:
    """Raise unless ``h`` rows split into ``n`` shards of at least ``radius``
    rows each (a halo comes from the neighbouring shard alone)."""
    if h % n or h // n < radius:
        raise ValueError(f"{h} BEV rows do not split into {n} shards of >= {radius} rows")


def local(v_with_halo: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor, radius: int) -> torch.Tensor:
    """One shard: ``v_with_halo [B, L, Hb + 2R, W, M, D]`` (its rows and the
    halo), its queries' ``offsets [B, C, Hb, W, M, L, P, 2]`` and ``weights
    [B, C, Hb, W, M, L, P]`` -> ``[B, C, Hb, W, M*D]`` f32."""
    return windowed_attention(v_with_halo, offsets, weights, radius=radius, row_halo=True, flatten=False)


def bev_row_sharded_windowed_attention(value: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor, mesh,
                                       radius: int = 4) -> torch.Tensor:
    """Windowed attention with the BEV H axis sharded over ``mesh``'s ``bev``
    group: ``value [B, L, H, W, M, D]``, ``offsets [B, C, H, W, M, L, P, 2]``
    and ``weights [B, C, H, W, M, L, P]``, the same on every rank ->
    ``[B, C, H, W, M*D]`` f32, the same on every rank. Requires ``H % n ==
    0`` and ``H // n >= radius``."""
    group = mesh.group("bev")
    check_bev_shards(value.shape[2], group_size(group), radius)
    v, o, w = (take_rows(t, group, dim=2) for t in (value, offsets, weights))
    return gather_rows(local(halo_exchange(v, group, radius), o, w, radius), group, dim=2)


def compose_bev_shards(value: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor, n: int,
                       radius: int = 4) -> torch.Tensor:
    """The ``n`` shards of :func:`bev_row_sharded_windowed_attention` in one
    process, one after another: shard j's halo is cut from the full map with
    ``radius`` zero rows added above and below it. Differentiable; the
    gradients of two shards' overlapping halo rows add up in autograd."""
    h = value.shape[2]
    check_bev_shards(h, n, radius)
    rows = h // n
    pad = value.new_zeros(value.shape[:2] + (radius,) + value.shape[3:])
    padded = torch.cat([pad, value, pad], dim=2)
    return torch.cat([local(padded[:, :, j * rows:(j + 1) * rows + 2 * radius],
                            offsets[:, :, j * rows:(j + 1) * rows], weights[:, :, j * rows:(j + 1) * rows], radius)
                      for j in range(n)], dim=2)
