"""Dilated ResNet-18 trunk, port of ``mvdetr_tpu/models/resnet.py:34-118``.

With ``replace_stride_with_dilation=(False, True, True)`` the output stride is
8: layer3 and layer4 fold their stride into dilation. As in the JAX module
(and unlike torchvision's block), only ``conv1`` of a block is dilated: the
first block of a stage uses the previous stage's dilation, the later blocks
the stage's own, and ``conv2`` always has dilation 1. The stem max-pool is
3/2/pad 1. Training mode reaches every BatchNorm through ``Module.train()``:
in training they take batch statistics over the flattened B*N views and
update their running statistics, as the Flax trunk does with ``train=True``;
in eval mode they use the running statistics (eps 1e-5).

The trunk is ``Sequential(conv1, bn1, relu, maxpool, layer1..layer4)``, the
layout of ``nn.Sequential(*resnet18.children())[:-2]``, so its state_dict
keys are the reference checkpoint's ``base.{0,1,4..7}.*``.

With ``remat=True`` each residual block is rematerialised in training, as
``nn.remat(BasicBlock)`` of the JAX trunk: ``torch.utils.checkpoint``
(``use_reentrant=False``) keeps only the block's input and reruns its forward
in the backward. The rerun leaves the BatchNorms' running statistics alone
(the first forward updated them), so a step with remat equals one without,
bit for bit, running statistics included. A block draws no dropout, so the
rerun draws nothing from a generator either.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mvdetr_tpu_torch.models.layers import BatchNorm2d, Conv2d, frozen_running_stats


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, dilation_conv1: int = 1,
                 use_projection: bool = False, dtype: torch.dtype = torch.float32, remat: bool = False,
                 generator=None):
        super().__init__()
        self.remat = remat
        self.conv1 = Conv2d(cin, features, 3, stride, padding=dilation_conv1, dilation=dilation_conv1,
                            bias=False, dtype=dtype, generator=generator)
        self.bn1 = BatchNorm2d(features, dtype)
        self.conv2 = Conv2d(features, features, 3, 1, padding=1, bias=False, dtype=dtype, generator=generator)
        self.bn2 = BatchNorm2d(features, dtype)
        self.downsample = None
        if use_projection:
            self.downsample = nn.Sequential(
                Conv2d(cin, features, 1, stride, bias=False, dtype=dtype, generator=generator),
                BatchNorm2d(features, dtype),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self._block(x)
        calls = []

        def run(inp):
            calls.append(None)
            if len(calls) == 1:
                return self._block(inp)
            with frozen_running_stats(self):  # the backward's rerun
                return self._block(inp)

        return checkpoint(run, x, use_reentrant=False)

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class _MaxPool(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf, as nn.max_pool


def resnet_features(stage_sizes: Sequence[int] = (2, 2, 2, 2),
                    replace_stride_with_dilation: Sequence[bool] = (False, True, True),
                    dtype: torch.dtype = torch.float32, remat: bool = False, generator=None) -> nn.Sequential:
    """ResNet-{18,34} feature trunk (no avgpool/fc): NCHW ``[B, 3, H, W]`` ->
    ``[B, 512, H/8, W/8]`` with the default dilation config; ``remat``
    rematerialises each residual block in training."""
    layers = [
        Conv2d(3, 64, 7, 2, padding=3, bias=False, dtype=dtype, generator=generator),
        BatchNorm2d(64, dtype),
        nn.ReLU(),
        _MaxPool(),
    ]
    dilation, features, in_features = 1, 64, 64
    for stage, blocks in enumerate(stage_sizes):
        stride = 1 if stage == 0 else 2
        previous_dilation = dilation
        if stage > 0 and replace_stride_with_dilation[stage - 1]:
            dilation *= stride
            stride = 1
        stage_blocks = []
        for block in range(blocks):
            first = block == 0
            stage_blocks.append(BasicBlock(
                in_features if first else features, features,
                stride=stride if first else 1,
                dilation_conv1=previous_dilation if first else dilation,
                use_projection=first and (stride != 1 or in_features != features),
                dtype=dtype, remat=remat, generator=generator,
            ))
        layers.append(nn.Sequential(*stage_blocks))
        in_features = features
        features *= 2
    return nn.Sequential(*layers)
