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

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mvdetr_tpu_torch.ops.batch_norm import batch_norm_2d, update_running_stats
from mvdetr_tpu_torch.utils.profiling import span


def lecun_normal_(t: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """Flax's default kernel init: truncated normal (+-2 std) with variance 1/fan_in."""
    fan_in = t.shape[1] * math.prod(t.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # std of the unit normal truncated at +-2
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def _init_weight(t: torch.Tensor, init: str, generator) -> None:
    with torch.no_grad():
        if init == "lecun":
            lecun_normal_(t, generator)
        elif init == "he":  # Flax's he_normal: the truncated normal of lecun_normal at twice the variance
            lecun_normal_(t, generator).mul_(math.sqrt(2.0))
        elif init == "xavier":
            nn.init.xavier_uniform_(t, generator=generator)
        elif init == "zeros":
            t.zero_()
        else:
            raise ValueError(f"unknown init {init!r}")


class _DeterministicBackwardConv(torch.autograd.Function):
    """``F.conv2d`` whose backward is the same ``convolution_backward`` that
    autograd calls, with cuDNN restricted to deterministic algorithms."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation, bias is not None)
        return F.conv2d(x, weight, bias, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, has_bias = ctx.conf
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, weight, [weight.shape[0]] if has_bias else None, [stride] * 2, [padding] * 2, [dilation] * 2,
                False, [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], has_bias and ctx.needs_input_grad[2]])
        finally:
            torch.backends.cudnn.deterministic = saved
        return gx, gw, gb, None, None, None


class Conv2d(nn.Module):
    """``nn.Conv`` of Flax on NCHW tensors (any memory format). With
    ``deterministic_backward`` the backward asks cuDNN for deterministic
    algorithms only (where its default one for the layer's shapes is not)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, bias: bool = True, dtype: torch.dtype = torch.float32,
                 init: str = "lecun", bias_value: float = 0.0, deterministic_backward: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.dtype = stride, padding, dilation, dtype
        self.deterministic_backward = deterministic_backward
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        _init_weight(self.weight, init, generator)
        self.bias = nn.Parameter(torch.full((cout,), float(bias_value))) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        conv = _DeterministicBackwardConv.apply if self.deterministic_backward else F.conv2d
        return conv(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding, self.dilation)


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
    """``nn.BatchNorm`` of Flax (momentum 0.9, eps 1e-5) on NCHW.

    In eval mode it normalises with the running statistics. In training mode
    it follows Flax, not ``F.batch_norm``: the statistics are taken in f32
    over (N, H, W) with the one-pass variance ``max(0, E[x^2] - E[x]^2)``
    (``use_fast_variance``), the normalisation runs in f32 and is rounded once
    to the compute dtype, and the running statistics move as
    ``0.9 * running + 0.1 * batch`` with the *biased* batch variance
    (`mvdetr_tpu/models/resnet.py:43-44,90`); ``num_batches_tracked`` counts
    the updates. Buffers are named as PyTorch's ``BatchNorm2d`` names them, so
    reference checkpoints load as they are. While ``freeze_stats`` is set
    (:func:`frozen_running_stats`), training mode still normalises with the
    batch statistics but leaves the running ones as they are.

    With a ``data_group`` (:func:`bind_data_axis`) the statistics are those of
    the global batch, as JAX's data-sharded step takes them: each rank's f32
    means of x and x^2 are all-reduced over the group (in rank order, with a
    backward that reaches the other ranks' inputs, as SyncBatchNorm's does)
    and divided by its size: the global batch's means, since every rank
    holds as many frames. The variance then follows the same formula. A
    group of one rank gives the ungrouped statistics' bits.

    On a CUDA tensor the hand-written kernels compute it (forward and
    backward, ``ops/batch_norm.py``, ``csrc/batch_norm.cu``); on any other
    the plain PyTorch version (:func:`~mvdetr_tpu_torch.ops.batch_norm.batch_norm_plain`).
    """

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.freeze_stats = False
        self.data_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("mvdetr:norm"):
            return batch_norm_2d(x, self.weight, self.bias, self.running_mean, self.running_var,
                                 self.num_batches_tracked, self.training, not self.freeze_stats, self.eps, self.dtype,
                                 self.data_group)

    def _update_running_stats(self, mean, var):
        update_running_stats(self.running_mean, self.running_var, self.num_batches_tracked, mean, var)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within the block, no :class:`BatchNorm2d` under ``module`` updates its
    running statistics (a rematerialised forward recomputes a block whose
    statistics its first forward already took)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    saved = [m.freeze_stats for m in norms]
    for m in norms:
        m.freeze_stats = True
    try:
        yield
    finally:
        for m, s in zip(norms, saved):
            m.freeze_stats = s


class Dropout(nn.Module):
    """``nn.Dropout`` of Flax with masks from an explicit generator.

    In training mode (and at a rate above 0) each element, or with
    ``channels=True`` each whole channel of an NCHW map (the last two axes
    share a mask: Flax ``broadcast_dims=(1, 2)`` on NHWC, PyTorch's
    Dropout2d; a 5-D ``[B, N, C, H, W]`` map likewise), is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``; ``broadcast_dims``
    names further axes that share one mask, as Flax's do. The mask is drawn
    from ``self.generator``, which the train step sets
    (:func:`set_dropout_generator`); a generator on the input's device is
    required, so a run is reproducible from its seed. JAX's random bits
    cannot be matched, so the parity tests run at rate 0.

    ``shards``: ``(axis, i, n)`` triples (:func:`bind_data_axis`,
    :func:`bind_view_axis`): along each such axis the input is rank i's block
    of a global input n times as large (the frames over ``data``, the cameras
    or their tokens over ``view``). The mask is drawn for the global input
    and this rank keeps its block, so the ranks together apply the mask of
    the one-process step.
    """

    def __init__(self, p: float, channels: bool = False, broadcast_dims: tuple = ()):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout rate must be in [0, 1], got {p}")
        self.p, self.channels, self.broadcast_dims = float(p), channels, tuple(broadcast_dims)
        self.generator: torch.Generator | None = None
        self.shards: tuple = ()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise ValueError("Dropout in training mode needs a generator: set it with set_dropout_generator "
                             "(train_step does)")
        shape = tuple(x.shape[:-2]) + (1, 1) if self.channels else tuple(x.shape)
        shape = tuple(1 if i in self.broadcast_dims else s for i, s in enumerate(shape))
        shards = [(axis, i, n) for axis, i, n in self.shards if n > 1 and axis not in self.broadcast_dims]
        full = list(shape)
        for axis, _, n in shards:
            full[axis] *= n
        keep = torch.rand(full, generator=self.generator, device=x.device) >= self.p
        for axis, i, _ in shards:
            keep = keep.narrow(axis, i * shape[axis], shape[axis])
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


def bind_data_axis(module: nn.Module, mesh, stats_axis="data") -> None:
    """Put every :class:`BatchNorm2d` and :class:`Dropout` under ``module``
    on ``mesh``'s ``data`` axis: batch statistics over the group of
    ``stats_axis`` (``"data"``, or ``("data", "view")`` for a trunk whose
    cameras are split over ``view``: JAX's statistics over the global
    ``B*N``), dropout masks cut from the global batch's."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.data_group = mesh.group(stats_axis)
        elif isinstance(m, Dropout):
            m.shards = ((0, mesh.index("data"), mesh.shape["data"]),)


def bind_view_axis(module: nn.Module, mesh, axis: int = 1) -> None:
    """Cut the masks of every :class:`Dropout` under ``module`` also along
    ``axis`` to this rank's block of the ``view`` axis: the module runs on
    this rank's cameras (or their tokens), and the mask is drawn for all of
    them. Call after :func:`bind_data_axis`."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.shards = tuple(m.shards) + ((axis, mesh.index("view"), mesh.shape["view"]),)


def set_dropout_generator(module: nn.Module, generator: torch.Generator | None) -> None:
    """Point every :class:`Dropout` under ``module`` at ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class LayerNorm(nn.Module):
    """``nn.LayerNorm`` of Flax over the last axis: eps 1e-6 and the
    one-pass variance ``max(0, E[x^2] - E[x]^2)``, in f32."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("mvdetr:norm"):
            x32 = x.float()
            mean = x32.mean(-1, keepdim=True)
            var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
            y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
            return y.to(self.dtype)
