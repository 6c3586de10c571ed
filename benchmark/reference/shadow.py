"""The 8-point shadow transformer in plain PyTorch, the reference of the
``warped`` configuration.

The MVDeTr paper's headline model (arXiv 2108.05888, `models/mvdetr.py:33-71`):
each camera's ``n_points`` points of a BEV cell lie on that camera's
vertical "shadow" ray, at the heights ``cfg["shadow_heights_m"]``. Every
layer, trunk, head, the camera warp and the rounding points are those of
:mod:`benchmark.reference.model`; what is its own:

- the reference map (:func:`reference_points`): each encoder cell lifted to
  height z through each camera (ground grid -> image at z) and dropped back
  to the ground (image -> ground grid at 0), by
  :func:`benchmark.reference.geometry.plane_homography`;
- the ``warped`` attention (:class:`WarpedAttn`): each camera's value map
  resampled bilinearly (zero outside) at its point maps, pixel centres at
  ``ref * [W, H] - 0.5``, into a stack of ``L*P`` maps rounded as the
  precision says (the program stores it in the compute dtype); then every
  map of the stack sampled as one level of one point at the query's cell
  plus its offset clamped to ``+-radius``, with the softmax over (levels,
  points). The offsets move the sample on the warped chart of the query
  grid, and a sample interpolates the resampled map, where the paper
  samples the camera's map at ``shadow(u) + o`` directly;
- :func:`offset_bias`: the radial bias with its rings within
  ``attn_radius``, as the clamped modes initialise it.

Everything computes in f32 (no TF32: the caller turns it off on the card);
``precision`` ``"fp8"`` and ``"bf16"`` round where :mod:`model` rounds, and
the stack besides. No module here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import geometry, model
from benchmark.reference.model import bilinear, deformable_sample, radial_offset_bias, warp_coords  # noqa: F401

DOWNSAMPLE = 2  # the encoder grid's stride on the reduced BEV grid


def reference_points(rig: dict, world_reduce: int, downsample: int, heights_m) -> np.ndarray:
    """``[Hs*Ws, N, P, 2]`` f32, normalised by ``(Ws, Hs)``: for each cell of
    the encoder grid, each camera and each height z, the ground point under
    the cell seen at height z through the camera."""
    h, w = (s // world_reduce // downsample for s in rig["worldgrid_shape"])
    ys, xs = np.meshgrid(np.linspace(0.5, h - 0.5, h), np.linspace(0.5, w - 0.5, w), indexing="ij")
    ref = np.stack([xs, ys], axis=-1).reshape(-1, 2)
    grid = geometry.grid_from_worldcoord(rig, world_reduce, downsample)
    out = np.zeros([h * w, rig["num_cam"], len(heights_m), 2], dtype=np.float32)
    for cam in range(rig["num_cam"]):
        ground = grid @ np.linalg.inv(geometry.plane_homography(rig, cam, 0.0))  # image -> grid at 0
        for i, z in enumerate(heights_m):
            lifted = grid @ np.linalg.inv(geometry.plane_homography(rig, cam, z))  # image -> grid at z
            out[:, cam, i, :] = geometry.project(ground, geometry.project(np.linalg.inv(lifted), ref))
    out[..., 0] /= w
    out[..., 1] /= h
    return out


def shadow_pixels(ref: np.ndarray, h: int, w: int) -> torch.Tensor:
    """``[2, L, Hs*Ws, P]`` f32 pixel coordinates (x, y; pixel i centred at
    i) of a normalised map ``[Hs*Ws, L, P, 2]``: ``ref * [W, H] - 0.5``."""
    x = ref[..., 0] * np.float32(w) - np.float32(0.5)
    y = ref[..., 1] * np.float32(h) - np.float32(0.5)
    return torch.from_numpy(np.stack([x, y]).transpose(0, 2, 1, 3).copy())


def resample(value: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``value [B, L, H, W, M, D]`` sampled bilinearly (zero outside) at each
    level's maps ``xy [2, L, H*W, P]``: the stack ``[B, L*P, H, W, M, D]`` in
    (level, point) order."""
    b, l, h, w, m, d = value.shape
    p = xy.shape[-1]
    table = value.reshape(b * l * h * w, m * d)
    base = (torch.arange(b * l, device=value.device) * h * w).view(b, l, 1, 1, 1)
    x = xy[0].expand(b, l, h * w, p)[..., None]
    y = xy[1].expand(b, l, h * w, p)[..., None]
    stack = bilinear(table, base, x, y, h, w, 1.0)  # [B, L, H*W, P, M*D]
    return stack.permute(0, 1, 3, 2, 4).reshape(b, l * p, h, w, m, d)


class WarpedAttn(model.MSDeformAttn):
    """``MSDeformAttn`` in ``warped`` mode: the same projections and names,
    its value resampled at the shadow maps ``xy`` (:func:`shadow_pixels`),
    then sampled windowed over the stack's ``L*P`` maps."""

    def __init__(self, prec, d_model, n_levels, n_heads, n_points, radius, xy):
        super().__init__(prec, d_model, n_levels, n_heads, n_points, "windowed", radius, None)
        self.register_buffer("shadow_xy", xy, persistent=False)

    def forward(self, query, src, h, w):
        b, q, c = query.shape
        m, l, p = self.m, self.l, self.p
        value = self.value_proj(src).reshape(b, l, h, w, m, c // m)
        offsets = self.sampling_offsets(query).reshape(b, q, m, l * p, 1, 2)
        weight = F.softmax(self.attention_weights(query).reshape(b, q, m, l * p), dim=-1).reshape(b, q, m, l * p, 1)
        weight = self.prec(weight)
        x, y = self.coords(offsets, h, w)
        if value.requires_grad or offsets.requires_grad:
            stack = self.prec(checkpoint(resample, value, self.shadow_xy, use_reentrant=False))
            out = checkpoint(deformable_sample, stack, x, y, weight, use_reentrant=False)
        else:
            out = deformable_sample(self.prec(resample(value, self.shadow_xy)), x, y, weight)
        return self.output_proj(self.prec(out))


class MVDeTr(model.MVDeTr):
    """:class:`benchmark.reference.model.MVDeTr` with every encoder layer's
    attention a :class:`WarpedAttn` on the rig's shadow maps; the same
    ``forward`` and state-dict names."""

    def __init__(self, cfg: dict, rig: dict, precision: str = "f32"):
        super().__init__(cfg, rig, precision)
        feat = self.world_feat
        hs, ws = feat.grid
        ref = reference_points(rig, cfg["world_reduce"], DOWNSAMPLE, cfg["shadow_heights_m"])
        if ref.shape[2] != cfg["n_points"]:
            raise ValueError(f"{ref.shape[2]} shadow heights for n_points {cfg['n_points']}")
        xy = shadow_pixels(ref, hs, ws)
        for layer in feat.encoder.layers:
            layer.self_attn = WarpedAttn(self.prec, feat.c, feat.n, cfg["nhead"], cfg["n_points"], cfg["attn_radius"],
                                         xy)


def offset_bias(cfg: dict) -> np.ndarray:
    """The ``sampling_offsets`` bias of the benchmark's initialisation: the
    radial bias, its rings within ``attn_radius`` (the offsets are clamped)."""
    return radial_offset_bias(cfg["nhead"], cfg["num_cam"], cfg["n_points"], cfg["attn_radius"])

