"""Prediction heads, port of ``mvdetr_tpu/models/heads.py``.

An optional 3x3 + ReLU neck, then a 1x1 projection. Heatmap heads start
with bias -2.19 (initial sigmoid ~0.1), the others with zero. Logits are
returned in f32 whatever the compute dtype. The head is a ``Sequential`` so
its keys are the reference checkpoint's ``<head>.0`` (projection only) or
``<head>.0`` / ``<head>.2`` (neck and projection).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mvdetr_tpu_torch.models.layers import Conv2d

HEATMAP_BIAS_INIT = -2.19


class OutputHead(nn.Sequential):
    """NCHW features in, NHWC f32 logits ``[B, H, W, out_dim]`` out."""

    def __init__(self, cin: int, out_dim: int, feat_dim: int = 0, final_bias: float = 0.0,
                 dtype: torch.dtype = torch.float32, generator=None):
        layers = []
        if feat_dim:
            layers += [Conv2d(cin, feat_dim, 3, padding=1, dtype=dtype, generator=generator), nn.ReLU()]
            cin = feat_dim
        layers.append(Conv2d(cin, out_dim, 1, dtype=dtype, bias_value=final_bias, generator=generator))
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).permute(0, 2, 3, 1).float()
