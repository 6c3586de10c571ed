"""BEV multiview fusion, port of ``mvdetr_tpu/models/world_feat/modules.py``.

Only the shadow transformer (``DeformTransWorldFeat``) in windowed mode is
ported in this slice; ``build_world_feat`` raises for the other four variants
(ROADMAP item A8).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from mvdetr_tpu_torch.models.deformable import DeformableEncoder
from mvdetr_tpu_torch.models.layers import Conv2d
from mvdetr_tpu_torch.models.pos_embed import sine_pos_embedding


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` f32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis (``jax/_src/image/scale.py::compute_weight_mat``, in f32
    as there): the triangle kernel at half-pixel centres, widened by the
    ratio when downsampling (JAX's default antialias), each output's weights
    renormalised over the taps inside the input, and outputs whose centre
    lies outside the input zeroed. For upsampling this is PyTorch's
    ``align_corners=False`` bilinear with its edge clamp."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    dist = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float32)[None, :]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - dist)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0).astype(np.float32)


def _resize_bilinear(x: torch.Tensor, out_hw, mats=None) -> torch.Tensor:
    """NCHW bilinear resize equal to ``jax.image.resize(..., "bilinear")``
    (`mvdetr_tpu/models/world_feat/modules.py:36-38`), as the separable
    product ``y = Ry @ x @ Rx^T`` with the :func:`resize_matrix` weights
    (``mats = (Ry [Ho, Hi], Rx^T [Wi, Wo])`` f32, built when not given).

    Both products run in f32 and the result is cast back to ``x``'s dtype
    once. Its backward is two more matrix products: no scatter and no float
    atomics, so a train step on the card repeats bitwise (PyTorch's
    bilinear ``interpolate`` accumulates its CUDA backward with atomics)."""
    hi, wi = x.shape[-2:]
    if mats is None:
        mats = (torch.from_numpy(resize_matrix(hi, int(out_hw[0]))).to(x.device),
                torch.from_numpy(resize_matrix(wi, int(out_hw[1])).T.copy()).to(x.device))
    ry, rx_t = mats
    if (ry.shape[1], rx_t.shape[0]) != (hi, wi):
        raise ValueError(f"resize matrices take {ry.shape[1]}x{rx_t.shape[0]} inputs, got {hi}x{wi}")
    return torch.matmul(ry, torch.matmul(x.float(), rx_t)).to(x.dtype)  # width first: fewer operations


class _Resize(nn.Module):
    """Bilinear resize from ``in_hw`` to ``out_hw``; the two f32 weight
    matrices are non-persistent buffers (they follow ``.to(device)`` and stay
    out of ``state_dict``, whose names stay the reference's)."""

    def __init__(self, in_hw, out_hw):
        super().__init__()
        self.out_hw = tuple(int(v) for v in out_hw)
        self.register_buffer("ry", torch.from_numpy(resize_matrix(int(in_hw[0]), self.out_hw[0])), persistent=False)
        self.register_buffer("rx_t", torch.from_numpy(resize_matrix(int(in_hw[1]), self.out_hw[1]).T.copy()),
                             persistent=False)

    def forward(self, x):
        return _resize_bilinear(x, self.out_hw, (self.ry, self.rx_t))


def resolve_attn_mode(attn_mode: str, reference_points: Optional[np.ndarray], hs: int, ws: int) -> str:
    """``'auto'`` -> ``'windowed'`` when the reference map is the identity grid
    (the ``n_points=4``, all-z=0 flagship), ``'warped'`` for a general map,
    ``'gather'`` without one (`modules.py:134-149`)."""
    if attn_mode != "auto":
        return attn_mode
    if reference_points is None:
        return "gather"
    ref = np.asarray(reference_points)
    ys, xs = np.meshgrid(np.linspace(0.5, hs - 0.5, hs) / hs,
                         np.linspace(0.5, ws - 0.5, ws) / ws, indexing="ij")
    ident = np.stack([xs, ys], -1).reshape(-1, 2)
    ident = np.tile(ident[None, :, None, None, :],
                    (ref.shape[0] // (hs * ws), 1, ref.shape[1], ref.shape[2], 1)).reshape(ref.shape)
    return "windowed" if np.allclose(ref, ident, atol=1e-3) else "warped"


class DeformTransWorldFeat(nn.Module):
    """The shadow transformer: each camera is one attention level, the queries
    are all N*Hs*Ws cells of the stride-2 BEV grid. ``[B, N, H, W, C]`` NHWC
    in, ``[B, H, W, C]`` NHWC out.

    The attention mode is resolved at construction, from ``reference_points``
    (``[N*Hs*Ws, N, P, 2]``, `models/mvdetr.py:129-130`), since the grid size
    is known from ``world_shape`` already.
    """

    def __init__(self, num_cam: int, world_shape: Tuple[int, int], base_dim: int = 128,
                 hidden_dim: int = 128, nhead: int = 8, dim_feedforward: int = 512, dropout: float = 0.1,
                 n_points: int = 4, stride: int = 2, reference_points: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.float32, attn_mode: str = "auto", attn_radius: int = 4,
                 generator=None):
        super().__init__()
        self.num_cam, self.hidden_dim, self.dtype = num_cam, hidden_dim, dtype
        self.world_shape = tuple(int(v) for v in world_shape)
        # conv 3x3 / stride / pad 1 output size
        self.grid = tuple((s - 1) // stride + 1 for s in self.world_shape)
        self.mode = resolve_attn_mode(attn_mode, reference_points, *self.grid)
        self.downsample = nn.Sequential(
            Conv2d(base_dim, hidden_dim, 3, stride, padding=1, dtype=dtype, init="xavier", generator=generator),
            nn.ReLU(),
        )
        self.lvl_embedding = nn.Parameter(torch.empty(num_cam, hidden_dim))
        with torch.no_grad():
            nn.init.normal_(self.lvl_embedding, 0.0, 1.0, generator=generator)
        self.encoder = DeformableEncoder(3, hidden_dim, dim_feedforward, dropout, num_cam, nhead, n_points, dtype,
                                         self.mode, attn_radius, generator)
        self.merge_linear = nn.Sequential(
            Conv2d(num_cam * hidden_dim, hidden_dim, 1, dtype=dtype, init="xavier", generator=generator),
            nn.ReLU(),
        )
        self.upsample = nn.Sequential(
            _Resize(self.grid, self.world_shape),
            Conv2d(hidden_dim, hidden_dim, 3, padding=1, dtype=dtype, init="xavier", generator=generator),
            nn.ReLU(),
        )
        hs, ws = self.grid
        pos = torch.from_numpy(sine_pos_embedding((hs, ws), hidden_dim // 2)).reshape(1, 1, hs * ws, hidden_dim)
        self.register_buffer("pos", pos, persistent=False)

    def forward(self, x: torch.Tensor):
        """Returns ``(y [B, H, W, C], offset_clip_fraction per layer)``."""
        b, n, h, w, c = x.shape
        y = self.downsample(x.reshape(b * n, h, w, c).permute(0, 3, 1, 2))  # NCHW
        hs, ws = y.shape[2], y.shape[3]
        if (hs, ws) != self.grid:
            raise ValueError(f"input grid {h}x{w} does not match world_shape {self.world_shape}")
        tokens = y.permute(0, 2, 3, 1).reshape(b, n * hs * ws, self.hidden_dim)
        pos_lvl = (self.pos.to(y.dtype) + self.lvl_embedding[None, :, None, :].to(y.dtype))
        pos_lvl = pos_lvl.reshape(1, n * hs * ws, self.hidden_dim)
        tokens, clips = self.encoder(tokens, (hs, ws), pos_lvl)
        # camera-major merge: [B, N, hs, ws, C] -> [B, hs, ws, N*C] (`modules.py:185`)
        y = tokens.reshape(b, n, hs, ws, self.hidden_dim).permute(0, 2, 3, 1, 4)
        y = y.reshape(b, hs, ws, n * self.hidden_dim).permute(0, 3, 1, 2)
        y = self.upsample(self.merge_linear(y))
        return y.permute(0, 2, 3, 1), clips


def build_world_feat(arch: str, num_cam: int, world_shape, base_dim: int = 128,
                     reference_points: Optional[np.ndarray] = None, n_points: int = 4,
                     dtype: torch.dtype = torch.float32, attn_mode: str = "auto", attn_radius: int = 4,
                     dropout: float = 0.1, generator=None) -> nn.Module:
    """Variant dispatch; ``deform_trans`` only in this slice. ``dropout`` is
    the encoder's rate: 0.1 as in the JAX module (`modules.py:125`), which
    does not expose it."""
    if arch == "deform_trans":
        return DeformTransWorldFeat(num_cam, world_shape, base_dim, hidden_dim=base_dim, dropout=dropout,
                                    n_points=n_points, reference_points=reference_points, dtype=dtype,
                                    attn_mode=attn_mode, attn_radius=attn_radius, generator=generator)
    if arch in ("conv", "trans", "aio", "deform_conv"):
        raise NotImplementedError(f"world_feat {arch!r} waits for ROADMAP item A8; this slice ports deform_trans")
    raise ValueError(f"unknown world_feat arch: {arch}")
