"""Perspective (homography) warp of NHWC feature maps, port of ``mvdetr_tpu/ops/warp.py``.

``mats`` map source pixels to destination pixels; each destination cell
samples the source at the inverse-mapped coordinate (bilinear, zero outside).
The JAX forward is a plain XLA gather with no Pallas kernel, so a plain torch
gather (:func:`~mvdetr_tpu_torch.ops.sampling.bilinear_patch_sample`) is its
counterpart here. Forward only in this slice.
"""

from __future__ import annotations

import torch

from mvdetr_tpu_torch.ops.sampling import bilinear_patch_sample


def invert_3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det), ``m [..., 3, 3]``.

    The same arithmetic as the JAX function, so the bits match (an LU-based
    ``torch.linalg.inv`` would round differently).
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _warp_coords(mats: torch.Tensor, out_shape):
    """Source pixel coords sampled by each destination cell: two ``[B, Ho*Wo]`` tensors."""
    ho, wo = out_shape
    inv = invert_3x3(mats.to(torch.float32))  # dst -> src
    ys, xs = torch.meshgrid(
        torch.arange(ho, dtype=torch.float32, device=mats.device),
        torch.arange(wo, dtype=torch.float32, device=mats.device),
        indexing="ij",
    )
    dst = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)  # [Ho*Wo, 3]
    src = torch.einsum("bij,qj->bqi", inv, dst)
    eps = 1e-8
    z = src[..., 2]
    # keep the sign of a vanishing z (`warp.py:64-66`): points on the horizon
    # map far outside the source instead of to inf/nan
    z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)
    return src[..., 0] / z, src[..., 1] / z


def perspective_warp(feats: torch.Tensor, mats: torch.Tensor, out_shape) -> torch.Tensor:
    """Warp ``feats [B, H, W, C]`` by per-sample homographies ``mats [B, 3, 3]``
    to ``[B, Ho, Wo, C]``, zeros outside the source support."""
    ho, wo = out_shape
    b, _, _, c = feats.shape
    sx, sy = _warp_coords(mats, out_shape)
    return bilinear_patch_sample(feats, sx, sy).reshape(b, ho, wo, c)
