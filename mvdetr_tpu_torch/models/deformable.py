"""Deformable-attention modules, port of ``mvdetr_tpu/models/deformable.py``.

Windowed mode only in this slice: the reference map is the identity grid
(the ``n_points=4`` flagship), every sample sits at its query's cell plus a
learned offset clamped to ``+-radius``, and the sampling runs through
:func:`mvdetr_tpu_torch.ops.msda_windowed.windowed_attention` (the CUDA
kernel on the card). The ``gather`` and ``warped`` modes wait for ROADMAP
item A8 and raise.

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

from mvdetr_tpu_torch.models.layers import LayerNorm, Linear
from mvdetr_tpu_torch.ops.msda_windowed import windowed_attention

_MODES_LATER = "the 'gather' and 'warped' attention modes wait for ROADMAP item A8"


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


def offset_clip_fraction(offsets: torch.Tensor, radius: float) -> torch.Tensor:
    """Fraction of offset components the windowed clamp binds: the mean over
    each sample's components, then over the batch (the JAX "staged" form)."""
    part = (offsets.abs() > float(radius)).float().mean(dim=tuple(range(2, offsets.dim())))
    return part.mean()


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention over ``n_levels`` same-shape grids
    whose queries are the ``C`` aligned copies of the grid (windowed mode)."""

    def __init__(self, d_model: int = 128, n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 dtype: torch.dtype = torch.float32, mode: str = "windowed", radius: int = 4,
                 generator=None):
        super().__init__()
        if mode != "windowed":
            raise NotImplementedError(f"MSDeformAttn mode {mode!r}: {_MODES_LATER}")
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        self.dtype, self.radius = dtype, radius
        m, l, p = n_heads, n_levels, n_points
        self.value_proj = Linear(d_model, d_model, dtype, generator=generator)
        self.sampling_offsets = Linear(d_model, m * l * p * 2, dtype, init="zeros",
                                       bias_init=radial_offset_bias(m, l, p, max_radius=float(radius)))
        self.attention_weights = Linear(d_model, m * l * p, dtype, init="zeros")
        self.output_proj = Linear(d_model, d_model, dtype, generator=generator)

    def forward(self, query: torch.Tensor, input_flatten: torch.Tensor, spatial_shape):
        """``query [B, Q, C]``, ``input_flatten [B, S, C]`` (level-major, every
        level ``spatial_shape = (H, W)``) -> ``(out [B, Q, C], offset_clip_fraction)``."""
        m, l, p = self.n_heads, self.n_levels, self.n_points
        d = self.d_model // m
        b, q, _ = query.shape
        h, w = spatial_shape
        if input_flatten.shape[1] != l * h * w or q % (h * w) != 0:
            raise ValueError("windowed mode needs level-major tokens on aligned same-shape grids")
        c = q // (h * w)
        value = self.value_proj(input_flatten).reshape(b, l, h, w, m, d)
        offsets = self.sampling_offsets(query).reshape(b, q, m, l, p, 2).float()
        # softmax over (levels, points) in f32, then the value dtype (`deformable.py:170-171`)
        weights = F.softmax(self.attention_weights(query).reshape(b, q, m, l * p).float(), dim=-1)
        weights = weights.to(value.dtype)
        clip = offset_clip_fraction(offsets, self.radius)
        out = windowed_attention(value, offsets.reshape(b, c, h, w, m, l, p, 2),
                                 weights.reshape(b, c, h, w, m, l, p), radius=self.radius)
        return self.output_proj(out), clip


class DeformableEncoderLayer(nn.Module):
    """Post-norm self-attention + FFN with the positional embedding added to
    the query only (`deformable_transformer.py:55-85`). Inference only: the
    dropouts of the JAX module are identities at ``train=False``."""

    def __init__(self, d_model: int = 128, d_ffn: int = 512, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, dtype: torch.dtype = torch.float32, mode: str = "windowed",
                 radius: int = 4, generator=None):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, dtype, mode, radius, generator)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Linear(d_model, d_ffn, dtype, generator=generator)
        self.linear2 = Linear(d_ffn, d_model, dtype, generator=generator)
        self.norm2 = LayerNorm(d_model, dtype)

    def forward(self, src, pos, spatial_shape):
        q = src if pos is None else src + pos
        attn, clip = self.self_attn(q, src, spatial_shape)
        src = self.norm1(src + attn)
        y = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + y), clip


class DeformableEncoder(nn.Module):
    """``num_layers`` encoder layers; returns the tokens and the per-layer
    ``offset_clip_fraction`` list (the JAX module sows it instead)."""

    def __init__(self, num_layers: int = 3, d_model: int = 128, d_ffn: int = 512, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4, dtype: torch.dtype = torch.float32,
                 mode: str = "windowed", radius: int = 4, generator=None):
        super().__init__()
        self.layers = nn.ModuleList([
            DeformableEncoderLayer(d_model, d_ffn, n_levels, n_heads, n_points, dtype, mode, radius, generator)
            for _ in range(num_layers)
        ])

    def forward(self, src, spatial_shape, pos=None):
        clips = []
        for layer in self.layers:
            src, clip = layer(src, pos, spatial_shape)
            clips.append(clip)
        return src, clips
