"""Layers with the compute-dtype policy of the Flax modules.

A Flax layer built with ``dtype=bf16`` keeps its parameters in f32 and casts
its input and its parameters to bf16 for the computation; with
``dtype=None`` everything stays f32. These layers do the same with explicit
casts (no ``autocast``), so the port rounds where the JAX package rounds.
Normalisations compute their statistics and their affine map in f32 and
round the result once, as ``flax.linen.normalization._normalize`` does.

Initialisers follow Flax's defaults (LeCun-normal kernels, zero biases) or
the initialiser a module names, drawn from an explicit ``torch.Generator``.
Layouts are PyTorch's (``OIHW`` conv kernels, ``[out, in]`` linear weights),
so the state_dict reads like the reference checkpoint's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def lecun_normal_(t: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """Flax's default kernel init: truncated normal (+-2 std) with variance 1/fan_in."""
    fan_in = t.shape[1] * math.prod(t.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # std of the unit normal truncated at +-2
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def _init_weight(t: torch.Tensor, init: str, generator) -> None:
    with torch.no_grad():
        if init == "lecun":
            lecun_normal_(t, generator)
        elif init == "xavier":
            nn.init.xavier_uniform_(t, generator=generator)
        elif init == "zeros":
            t.zero_()
        else:
            raise ValueError(f"unknown init {init!r}")


class Conv2d(nn.Module):
    """``nn.Conv`` of Flax on NCHW tensors (any memory format)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, bias: bool = True, dtype: torch.dtype = torch.float32,
                 init: str = "lecun", bias_value: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.dtype = stride, padding, dilation, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        _init_weight(self.weight, init, generator)
        self.bias = nn.Parameter(torch.full((cout,), float(bias_value))) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding, self.dilation)


class Linear(nn.Module):
    """``nn.Dense`` of Flax; ``weight`` is ``[out, in]`` as in PyTorch."""

    def __init__(self, fin: int, fout: int, dtype: torch.dtype = torch.float32, init: str = "xavier",
                 bias_init: torch.Tensor | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(fout, fin))
        _init_weight(self.weight, init, generator)
        bias = torch.zeros(fout) if bias_init is None else torch.as_tensor(bias_init, dtype=torch.float32)
        self.bias = nn.Parameter(bias.clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class BatchNorm2d(nn.Module):
    """Inference-mode ``nn.BatchNorm`` (running statistics, eps 1e-5) on NCHW.

    Buffers are named as PyTorch's ``BatchNorm2d`` names them, including
    ``num_batches_tracked``, so reference checkpoints load as they are.
    Batch statistics (training) come with the training slice.
    """

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` of Flax over the last axis: eps 1e-6 and the
    one-pass variance ``max(0, E[x^2] - E[x]^2)``, in f32."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)
