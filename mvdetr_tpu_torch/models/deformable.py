"""Deformable-attention modules, port of ``mvdetr_tpu/models/deformable.py``.

Three attention modes, on same-shape levels:

- ``windowed``: the reference map is the identity grid (the ``n_points=4``
  flagship) and the queries are the ``C`` camera copies of the grid; each
  sample sits at its query's cell plus a learned offset clamped to
  ``+-radius``, through
  :func:`mvdetr_tpu_torch.ops.msda_windowed.windowed_attention` (B1 and B2
  on the card);
- ``warped``: a general reference map such as the 8-point shadow map, the
  same camera-copy queries; the value stack is resampled at the map once,
  then sampled windowed over the ``L*P`` pseudo-levels
  (:func:`mvdetr_tpu_torch.ops.msda_warped.ms_deform_attn_warped`: B1 and
  B2, and B3 for the warp's backward, on the card);
- ``gather``: the reference semantics, with any queries (such as the
  ``aio`` variant's one per BEV cell) and unbounded offsets: each sample at
  ``reference + offset / [W, H]``
  (:func:`mvdetr_tpu_torch.ops.msda.ms_deform_attn_gather`: a plain gather
  forward, and B3 for the value's gradient on the card).

With a ``mesh`` whose ``bev`` axis holds more than one process, ``windowed``
attention runs BEV-row-sharded with a ``+-radius`` halo exchange
(:mod:`mvdetr_tpu_torch.ops.msda_sharded`; B1 and B2 in their ``row_halo``
mode on every shard), as JAX's module picks it (`deformable.py:111-136,204-209`).
With a ``view`` axis that splits the levels (the cameras,
:func:`~mvdetr_tpu_torch.parallel.mesh.view_shards`), ``windowed`` attention
takes this rank's query blocks: the value of its own tokens, gathered over
``view`` (:func:`~mvdetr_tpu_torch.parallel.collectives.gather_cams`), and
the offsets and weights of its own queries, so B1 and B2 run ``C = L / V``
query blocks over all ``L`` levels (JAX's ``qspec = P(data, view, bev)``,
`mvdetr_tpu/ops/msda_sharded.py:63-79`).

Parameter names follow the reference checkpoint
(``self_attn.{value_proj,sampling_offsets,attention_weights,output_proj}``,
``norm1``, ``linear1``, ``linear2``, ``norm2``, ``layers.{i}``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mvdetr_tpu_torch.models.layers import Dropout, LayerNorm, Linear
from mvdetr_tpu_torch.ops.msda import fma, ms_deform_attn_gather
from mvdetr_tpu_torch.ops.msda_sharded import bev_row_sharded_windowed_attention
from mvdetr_tpu_torch.ops.msda_warped import ms_deform_attn_warped, shadow_coords
from mvdetr_tpu_torch.ops.msda_windowed import windowed_attention
from mvdetr_tpu_torch.parallel.collectives import gather_cams
from mvdetr_tpu_torch.parallel.mesh import view_shards
from mvdetr_tpu_torch.utils.profiling import span

_MODES = ("windowed", "warped", "gather")
_logged = set()


def log_once(key: str, msg: str) -> None:
    """Print ``msg`` the first time ``key`` is seen in this process (a
    requested mesh axis that the attention cannot use is said once, loudly,
    as in the JAX package)."""
    if key not in _logged:
        _logged.add(key)
        print(f"mvdetr_tpu_torch: {msg}")


def radial_offset_bias(n_heads: int, n_levels: int, n_points: int,
                       max_radius: Optional[float] = None) -> np.ndarray:
    """Head-h points start along direction 2*pi*h/H, point i on ring i+1;
    ``max_radius`` rescales the rings so the outermost lands exactly on the
    windowed clamp. Copied from the JAX module."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(n_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    if max_radius is not None and n_points > max_radius:
        grid *= max_radius / n_points
    return grid.reshape(-1).astype(np.float32)


def grid_reference_points(spatial_shapes) -> np.ndarray:
    """Per-level half-centre reference grid, normalised, ``[S, L, 2]``
    (`deformable_transformer.py:29-41`): the map of an encoder built without
    one. Copied from the JAX module."""
    refs = []
    for h, w in spatial_shapes:
        ys, xs = np.meshgrid(
            np.linspace(0.5, h - 0.5, int(h)) / h, np.linspace(0.5, w - 0.5, int(w)) / w, indexing="ij"
        )
        refs.append(np.stack([xs, ys], -1).reshape(-1, 2))
    ref = np.concatenate(refs, 0)  # [S, 2]
    return np.tile(ref[:, None, :], (1, len(spatial_shapes), 1)).astype(np.float32)  # [S, L, 2]


def sampling_locations(reference_points: torch.Tensor, offsets: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Gather mode's ``ref + offsets / [W, H]`` in f32 (`deformable.py:203`),
    with XLA's arithmetic on the CPU: the division by the constant becomes a
    product with its f32 reciprocal, contracted with the sum into one fused
    multiply-add (:func:`mvdetr_tpu_torch.ops.msda.fma`). Differentiable in
    ``offsets`` (the cotangent times the reciprocal, as in JAX)."""
    recip = 1.0 / torch.tensor([float(w), float(h)], dtype=torch.float32, device=offsets.device)
    return fma(offsets, recip, reference_points)


def offset_clip_fraction(offsets: torch.Tensor, radius: float) -> torch.Tensor:
    """Fraction of offset components the windowed clamp binds: the mean over
    each sample's components, then over the batch (the JAX "staged" form)."""
    part = (offsets.abs() > float(radius)).float().mean(dim=tuple(range(2, offsets.dim())))
    return part.mean()


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention over ``n_levels`` same-shape grids.

    ``windowed`` and ``warped`` modes take queries that are the ``C``
    aligned copies of the grid. ``warped`` mode takes the static reference
    map ``reference_points`` (``[Q, L, P, 2]``, or ``[Q, L, 2]`` tiled to the
    ``P`` points, with ``Q`` a multiple of the ``spatial_shape`` grid's
    cells): the camera copies of the queries share its first ``H*W`` rows
    (`deformable.py:214-216`), held as pixel coordinates. ``gather`` mode
    takes any ``Q`` queries and their map (``[Q, L, P, 2]`` or ``[Q, L, 2]``,
    normalised; required), held as it is. Either buffer is non-persistent,
    so ``state_dict`` keeps the reference checkpoint's names. Only the
    clamped modes rescale the offsets' radial init to ``radius``
    (`deformable.py:158`). ``mesh``: see :meth:`_bev_shards` and
    ``view_group``: the ``view`` process group where this rank holds its
    block of the levels' tokens (``windowed`` mode, on a ``view`` axis that
    divides the levels), else None."""

    def __init__(self, d_model: int = 128, n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 dtype: torch.dtype = torch.float32, mode: str = "windowed", radius: int = 4,
                 generator=None, reference_points: Optional[np.ndarray] = None, spatial_shape=None, mesh=None):
        super().__init__()
        if mode not in _MODES:
            raise ValueError(f"unknown MSDeformAttn mode {mode!r}; the modes are {_MODES}")
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        self.dtype, self.radius, self.mode, self.mesh = dtype, radius, mode, mesh
        self.view_group = mesh.group("view") if mode == "windowed" and view_shards(mesh, n_levels) > 1 else None
        m, l, p = n_heads, n_levels, n_points
        self.value_proj = Linear(d_model, d_model, dtype, generator=generator)
        max_r = float(radius) if mode in ("windowed", "warped") else None  # `deformable.py:158-162`
        self.sampling_offsets = Linear(d_model, m * l * p * 2, dtype, init="zeros",
                                       bias_init=radial_offset_bias(m, l, p, max_radius=max_r))
        self.attention_weights = Linear(d_model, m * l * p, dtype, init="zeros")
        self.output_proj = Linear(d_model, d_model, dtype, generator=generator)
        if mode == "warped":
            if reference_points is None or spatial_shape is None:
                raise ValueError("warped mode needs reference_points and spatial_shape")
            h, w = (int(v) for v in spatial_shape)
            ref = np.asarray(reference_points, dtype=np.float32)
            ref = ref.reshape((-1, h * w) + ref.shape[1:])[0]  # the first camera copy
            if ref.ndim == 3:
                ref = np.tile(ref[:, :, None, :], (1, 1, p, 1))
            if ref.shape != (h * w, l, p, 2):
                raise ValueError(f"warped mode: reference map {ref.shape} does not fit {h}x{w} queries, "
                                 f"{l} levels, {p} points")
            self.spatial_shape = (h, w)
            self.reference_map = ref  # normalised, for utils/visualize.py::capture_attention
            self.register_buffer("shadow_xy", shadow_coords(ref, h, w), persistent=False)
        elif mode == "gather":
            if reference_points is None:
                raise ValueError("gather mode needs reference_points")
            ref = np.asarray(reference_points, dtype=np.float32)
            if ref.ndim == 3:
                ref = ref[:, :, None, :]
            if ref.ndim != 4 or ref.shape[1] != l or ref.shape[2] not in (1, p) or ref.shape[3] != 2:
                raise ValueError(f"gather mode: reference map {ref.shape} does not fit {l} levels, {p} points")
            # [Q, 1, L, P or 1, 2]: broadcast over the heads (and the points), as `deformable.py:190-193`
            self.register_buffer("reference_points", torch.from_numpy(ref[:, None].copy()), persistent=False)

    def _bev_shards(self, h: int) -> int:
        """The BEV-row shard count, or 1 where it does not apply: no mesh, a
        ``bev`` axis of one, a mode other than ``windowed``, or ``h`` rows that
        do not split into shards of at least ``radius`` rows. A ``bev`` axis
        that cannot be used is said once (`deformable.py:111-136`): a silent
        fallback would leave ``--bev_shards N`` doing nothing."""
        n = 1 if self.mesh is None else self.mesh.shape["bev"]
        if n <= 1:
            return 1
        if self.mode != "windowed":
            log_once(f"bev_shards_mode_{self.mode}",
                     f"mesh has bev={n} but attention mode is '{self.mode}' — BEV-row sharding only applies to "
                     f"'windowed'; running unsharded")
            return 1
        if h % n != 0 or h // n < self.radius:
            log_once(f"bev_shards_{h}_{n}",
                     f"mesh has bev={n} but encoder rows {h} are not divisible into >={self.radius}-row shards — "
                     f"running unsharded (pick bev_shards dividing {h})")
            return 1
        return n

    def project_value(self, input_flatten: torch.Tensor, spatial_shape) -> torch.Tensor:
        """The value of ``input_flatten [B, S, C]`` (level-major tokens of
        ``spatial_shape`` grids) as ``[B, S / (H*W), H, W, M, D]``: with a
        ``view_group``, this rank's levels only."""
        h, w = spatial_shape
        m = self.n_heads
        return self.value_proj(input_flatten).reshape(input_flatten.shape[0], -1, h, w, m, self.d_model // m)

    def forward(self, query: torch.Tensor, input_flatten: torch.Tensor, spatial_shape, value=None):
        """``query [B, Q, C]``, ``input_flatten [B, S, C]`` (level-major, every
        level ``spatial_shape = (H, W)``) -> ``(out [B, Q, C],
        offset_clip_fraction)``; the fraction is None in ``gather`` mode,
        which clamps nothing (JAX sows none there). With a ``view_group``
        the tokens and queries are this rank's levels' and the value of all
        levels is gathered over it; ``value`` (``[B, L, H, W, M, D]``, from
        :meth:`project_value` of every level's tokens) replaces that gather,
        as :meth:`~mvdetr_tpu_torch.models.world_feat.modules.DeformTransWorldFeat.compose_view_shards`
        passes it."""
        with span("mvdetr:attention"):
            if self.mode == "gather":
                return self._gather(query, input_flatten, spatial_shape), None
            m, l, p = self.n_heads, self.n_levels, self.n_points
            d = self.d_model // m
            b, q, _ = query.shape
            h, w = spatial_shape
            if q % (h * w) != 0 or input_flatten.shape[1] % (h * w) != 0:
                raise ValueError(f"{self.mode} mode needs level-major tokens on aligned same-shape grids")
            if self.mode == "warped" and (h, w) != self.spatial_shape:
                raise ValueError(f"warped mode: grid {h}x{w}, the reference map's is {self.spatial_shape}")
            c = q // (h * w)
            if value is None:
                value = gather_cams(self.project_value(input_flatten, spatial_shape), self.view_group, dim=1)
            if value.shape != (b, l, h, w, m, d):
                raise ValueError(f"{self.mode} mode: a value of {tuple(value.shape)} for {l} levels of {h}x{w}")
            offsets = self.sampling_offsets(query).reshape(b, q, m, l, p, 2).float()
            # softmax over (levels, points) in f32, then the value dtype (`deformable.py:170-171`)
            weights = F.softmax(self.attention_weights(query).reshape(b, q, m, l * p).float(), dim=-1)
            weights = weights.to(value.dtype)
            clip = offset_clip_fraction(offsets, self.radius)
            offsets = offsets.reshape(b, c, h, w, m, l, p, 2)
            weights = weights.reshape(b, c, h, w, m, l, p)
            if self.mode == "warped":
                out = ms_deform_attn_warped(value, self.shadow_xy, offsets, weights, radius=self.radius)
            elif self._bev_shards(h) > 1:
                out = bev_row_sharded_windowed_attention(value, offsets, weights, self.mesh, radius=self.radius)
                out = out.reshape(b, c * h * w, m * d)
            else:
                out = windowed_attention(value, offsets, weights, radius=self.radius)
            return self.output_proj(out), clip

    def _gather(self, query, input_flatten, spatial_shape):
        m, l, p = self.n_heads, self.n_levels, self.n_points
        b, q, _ = query.shape
        h, w = (int(v) for v in spatial_shape)
        if q != self.reference_points.shape[0]:
            raise ValueError(f"gather mode: {q} queries, the reference map has {self.reference_points.shape[0]}")
        value = self.value_proj(input_flatten).reshape(b, input_flatten.shape[1], m, self.d_model // m)
        offsets = self.sampling_offsets(query).reshape(b, q, m, l, p, 2).float()
        weights = F.softmax(self.attention_weights(query).reshape(b, q, m, l * p).float(), dim=-1)
        weights = weights.reshape(b, q, m, l, p).to(value.dtype)
        locations = sampling_locations(self.reference_points, offsets, h, w)
        return self.output_proj(ms_deform_attn_gather(value, (h, w), l, locations, weights))


class DeformableEncoderLayer(nn.Module):
    """Post-norm self-attention + FFN with the positional embedding added to
    the query only (`deformable_transformer.py:55-85`), with the JAX module's
    three dropouts (`mvdetr_tpu/models/deformable.py:233,250-255`): on the
    attention output, after the FFN's ReLU and on the FFN output. They act in
    training mode only."""

    def __init__(self, d_model: int = 128, d_ffn: int = 512, dropout: float = 0.1, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4, dtype: torch.dtype = torch.float32, mode: str = "windowed",
                 radius: int = 4, generator=None, reference_points: Optional[np.ndarray] = None,
                 spatial_shape=None, mesh=None):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, dtype, mode, radius, generator,
                                      reference_points, spatial_shape, mesh)
        self.dropout1 = Dropout(dropout)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Linear(d_model, d_ffn, dtype, generator=generator)
        self.dropout2 = Dropout(dropout)
        self.linear2 = Linear(d_ffn, d_model, dtype, generator=generator)
        self.dropout3 = Dropout(dropout)
        self.norm2 = LayerNorm(d_model, dtype)

    def forward(self, src, pos, spatial_shape, value=None):
        """``value``: see :meth:`MSDeformAttn.forward`."""
        q = src if pos is None else src + pos
        attn, clip = self.self_attn(q, src, spatial_shape, value)
        src = self.norm1(src + self.dropout1(attn))
        y = self.linear2(self.dropout2(F.relu(self.linear1(src))))
        return self.norm2(src + self.dropout3(y)), clip


class DeformableEncoder(nn.Module):
    """``num_layers`` encoder layers; returns the tokens and the per-layer
    ``offset_clip_fraction`` list (the JAX module sows it instead; empty in
    ``gather`` mode). ``reference_points`` and ``spatial_shape``: the static
    map of ``warped`` and ``gather`` mode (see :class:`MSDeformAttn`); in
    ``gather`` mode without a map, :func:`grid_reference_points` of the
    ``n_levels`` levels of ``spatial_shape``."""

    def __init__(self, num_layers: int = 3, d_model: int = 128, d_ffn: int = 512, dropout: float = 0.1,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 4, dtype: torch.dtype = torch.float32,
                 mode: str = "windowed", radius: int = 4, generator=None,
                 reference_points: Optional[np.ndarray] = None, spatial_shape=None, mesh=None):
        super().__init__()
        if mode == "gather" and reference_points is None:
            if spatial_shape is None:
                raise ValueError("gather mode without reference_points needs spatial_shape")
            reference_points = grid_reference_points((tuple(spatial_shape),) * n_levels)
        self.layers = nn.ModuleList([
            DeformableEncoderLayer(d_model, d_ffn, dropout, n_levels, n_heads, n_points, dtype, mode, radius,
                                   generator, reference_points, spatial_shape, mesh)
            for _ in range(num_layers)
        ])

    def forward(self, src, spatial_shape, pos=None):
        clips = []
        for layer in self.layers:
            src, clip = layer(src, pos, spatial_shape)
            if clip is not None:
                clips.append(clip)
        return src, clips
