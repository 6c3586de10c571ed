"""Shadow-warped deformable attention, port of ``mvdetr_tpu/ops/msda_warped.py``.

The attention for a general (non-identity) reference map, e.g. the 8-point
shadow configuration, where each camera's points lie on its vertical
"shadow" ray at heights -0.4 .. 1.8 m. Each (level l, point p) slice of the
map is a fixed projective map of the BEV query grid, which factors the
sampling into two dense stages:

1. **Shadow warp** (static): resample each level's value map at each of its
   point maps once, ``W[l,p][u] = bilinear(value_l, ref[u,l,p])``. This is the
   camera warp's primitive (``ops/warp.py::_PatchSampleFn``): a plain gather
   forward and, as backward, :func:`~mvdetr_tpu_torch.ops.warp.warp_scatter_accumulate`
   (kernel B3, ``csrc/warp_bwd.cu``, on the card). Plain autograd of the
   gather would scatter with ``index_add_``, whose float atomics would make
   the train step's bits change from run to run.
2. **Windowed attention on the warped stack**: the sampling reduces to the
   identity-reference case over ``L*P`` pseudo-levels of one point each,
   ``out[c,u,m] = sum_{l,p} w * bilinear(W[l,p], u + o)``, through one
   :func:`~mvdetr_tpu_torch.ops.msda_windowed.windowed_attention` call: one
   launch of B1 forward and one of B2 backward on the card.

Semantics (the JAX package's, a documented redesign like the windowed
clamp): learned offsets displace the query **on the warped (query-grid)
chart**, so a sample lands at ``shadow(u) + J(u)·o`` instead of the
reference's ``shadow(u) + o``; offsets are measured in shadow-ray
parameterised BEV cells, and the sample interpolates the already bilinearly
resampled warped map. At z = 0 the chart is the identity, so the
``n_points=4`` flagship is unaffected.

Summation order. The JAX package splits the stack into chunks of at most 8
pseudo-levels and adds the chunks' outputs (a limit of the TPU kernel's
VMEM). The port makes one call over all ``L*P`` pseudo-levels, so its f32
sum runs in (l, p) order over the whole stack: the two agree to f32
rounding, not bitwise.

Under a profiler, each :func:`shadow_warp_stack` call's forward is the span
``mvdetr:shadow_warp``, inside its layer's ``mvdetr:attention``;
``shadow_warp_stack.calls`` counts the calls, one an encoder layer and
forward. Its backward is B3, counted in ``warp_bwd.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from mvdetr_tpu_torch.ops.msda_windowed import windowed_attention
from mvdetr_tpu_torch.ops.warp import _PatchSampleFn
from mvdetr_tpu_torch.utils.profiling import span


def shadow_coords(ref_points, h: int, w: int) -> torch.Tensor:
    """Pixel coordinates of a reference map: ``ref_points [H*W, L, P, 2]``
    normalised to [0, 1] by (W, H) (``CameraRig.reference_points``) ->
    f32 ``[2, L, H*W*P]`` (x then y), ``x = ref_x * W - 0.5``,
    ``y = ref_y * H - 0.5`` (integer pixel centres), per level in (query,
    point) order. They are shared across the batch."""
    ref = torch.as_tensor(np.asarray(ref_points, dtype=np.float32))
    q, l, p, _ = ref.shape
    if q != h * w:
        raise ValueError(f"shadow_coords: a reference map of {q} queries does not fit the {h}x{w} grid")
    x = ref[..., 0] * w - 0.5
    y = ref[..., 1] * h - 0.5
    return torch.stack([x.permute(1, 0, 2).reshape(l, q * p), y.permute(1, 0, 2).reshape(l, q * p)])


def shadow_warp_stack(value: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Resample each level's map at its point maps: ``value [B, L, H, W, M, D]``
    and ``coords [2, L, H*W*P]`` from :func:`shadow_coords` -> the warped
    stack ``[B, L*P, H, W, M, D]`` in pseudo-level order (l, p), in
    ``value``'s dtype.

    Differentiable with respect to ``value`` (B3 on the card, its plain
    version on the CPU); the coordinates come from calibration and get no
    gradient. Adds one to ``shadow_warp_stack.calls`` a call."""
    b, l, h, w, m, d = value.shape
    if coords.shape[:2] != (2, l) or coords.shape[2] % (h * w):
        raise ValueError(f"shadow_warp_stack: coords {tuple(coords.shape)} do not fit value {tuple(value.shape)}")
    with span("mvdetr:shadow_warp"):
        p = coords.shape[2] // (h * w)
        coords = coords.to(device=value.device, dtype=torch.float32)
        sx = coords[0].repeat(b, 1)  # [B*L, H*W*P], contiguous as B3 takes them
        sy = coords[1].repeat(b, 1)
        taps = _PatchSampleFn.apply(value.reshape(b * l, h, w, m * d), sx, sy)  # [B*L, H*W*P, M*D]
        shadow_warp_stack.calls += 1
        return taps.reshape(b, l, h, w, p, m * d).permute(0, 1, 4, 2, 3, 5).reshape(b, l * p, h, w, m, d)


shadow_warp_stack.calls = 0


def ms_deform_attn_warped(
    value: torch.Tensor,  # [B, L, H, W, M, D]
    coords: torch.Tensor,  # [2, L, H*W*P] pixel coordinates of the reference map (shadow_coords)
    offsets: torch.Tensor,  # [B, C, H, W, M, L, P, 2] raw offsets in cells
    weights: torch.Tensor,  # [B, C, H, W, M, L, P] softmaxed over (L, P)
    radius: int = 4,
) -> torch.Tensor:
    """General-reference deformable attention by shadow warp and windowed
    sampling: ``[B, C*H*W, M*D]`` f32, differentiable in ``value``,
    ``offsets`` and ``weights``. See the module docstring for the offset
    reparameterisation and the summation order."""
    b, c, h, w, m, l, p, _ = offsets.shape
    warped = shadow_warp_stack(value, coords)
    return windowed_attention(warped, offsets.reshape(b, c, h, w, m, l * p, 1, 2),
                              weights.reshape(b, c, h, w, m, l * p, 1), radius=radius)
