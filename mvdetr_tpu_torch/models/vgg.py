"""VGG-11 feature trunk, port of ``mvdetr_tpu/models/vgg.py``.

The reference's surgery on ``torchvision.vgg11().features``: the last
max-pool and the ReLU after the seventh conv are replaced by identities,
leaving output stride 16 and 512 channels. The trunk is that
``nn.Sequential``, so its convs sit at the reference checkpoint's indices
``base.{0,3,6,8,11,13,16,18}``.

The JAX module has no ``dtype`` field: Flax promotes a bf16 input against
the f32 kernels, so the trunk computes in f32 whatever the model's compute
dtype, and so does this one.

Its convolutions take their backward with cuDNN's deterministic algorithms
(``Conv2d(deterministic_backward=True)``): on the H100 the default one for
the first conv's weight gradient (3 input channels at 720x1280, TF32) gave
two train steps from the same state different gradients, and a train step
repeats bit for bit in this port.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from mvdetr_tpu_torch.models.layers import Conv2d

# (channels, relu_after) per conv, "M" a 2x2 max-pool; the trailing pool is
# dropped and conv #7 (index 16) loses its ReLU, as in the reference
_LAYOUT = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", (512, False), 512)
# torchvision vgg11.features conv indices, in order
TORCHVISION_CONV_IDX = (0, 3, 6, 8, 11, 13, 16, 18)


def vgg11_features(generator=None) -> nn.Sequential:
    """NCHW ``[B, 3, H, W]`` -> ``[B, 512, H/16, W/16]`` in f32 (2x2
    max-pools, VALID as ``nn.max_pool``'s default)."""
    layers, cin = [], 3
    for spec in _LAYOUT:
        if spec == "M":
            layers.append(nn.MaxPool2d(2))
            continue
        ch, relu_after = spec if isinstance(spec, tuple) else (spec, True)
        layers += [Conv2d(cin, ch, 3, padding=1, deterministic_backward=True, generator=generator),
                   nn.ReLU() if relu_after else nn.Identity()]
        cin = ch
    return nn.Sequential(*layers)


def load_torchvision_vgg11_state_dict(state_dict: Mapping) -> dict:
    """torchvision ``vgg11`` weights (``features.N.weight/bias``, OIHW,
    tensors or numpy arrays) -> the trunk's ``base.N.*`` tensors; the
    classifier and every other key are left out, as the JAX loader leaves
    them."""
    out = {}
    for t in TORCHVISION_CONV_IDX:
        for kind in ("weight", "bias"):
            v = state_dict[f"features.{t}.{kind}"]
            out[f"base.{t}.{kind}"] = torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v))
    return out
