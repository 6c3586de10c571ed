"""BatchNorm2d of the trunk: the plain PyTorch function, its closed-form
backward, and the hand-written CUDA kernels ``csrc/batch_norm.cu``.

The function is the Flax contract that ``models/layers.py::BatchNorm2d``
documents: statistics in f32 over (N, H, W) with the one-pass variance
``max(0, E[x^2] - E[x]^2)``, ``(x - mean) * (rsqrt(var + eps) * weight) +
bias`` in f32 rounded once to the output type, running statistics ``0.9 *
running + 0.1 * batch``. The pieces:

- :func:`batch_norm_plain`: the function in plain PyTorch, differentiated by
  autograd. A CPU (or meta) tensor takes it.
- :func:`batch_norm_bwd_plain`: the backward in closed form, as the kernels
  compute it: per channel ``S0 = sum(dy)`` and ``S1 = sum(dy * (x - mean))``,
  then ``dx = dy * mul + (dmean / n + x * (2 * de2 / n))``.
- :func:`batch_norm` and :func:`batch_norm_bwd`: the wrappers of the
  kernels (no autograd). Each counts its calls in ``<wrapper>.launches``,
  one a call whatever number of kernels the call launches.
- :func:`batch_norm_2d`, the dispatch: a CUDA tensor goes through
  ``_BatchNormFn`` to the kernels, any other through the plain function,
  with no fallback between them.

The kernels take channels-last dense tensors, the layout the trunk feeds
them: rows of C channels, a thread loading 16 bytes of consecutive channels
where C allows (:func:`row_vec`). Any other input is made so first, and x
and dy take one dtype in the backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mvdetr_tpu_torch.ops import kernel_build
from mvdetr_tpu_torch.parallel.collectives import all_reduce_sum, group_size, reduce_sum

KERNEL_NAME = "batch_norm"
THREADS = 256  # a block's threads, C / vec at most this (csrc/batch_norm.cu: kThreads)
TILES_PER_SM, BLOCKS_PER_SM = 4, 8  # reduction slabs and elementwise blocks a multiprocessor, in rows
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DIMS = (0, 2, 3)


@torch.no_grad()
def update_running_stats(running_mean, running_var, num_batches_tracked, mean, var) -> None:
    """``0.9 * running + 0.1 * batch`` (the biased variance), and one more update counted."""
    running_mean.mul_(0.9).add_(0.1 * mean)
    running_var.mul_(0.9).add_(0.1 * var)
    num_batches_tracked.add_(1)


def batch_norm_plain(x, weight, bias, running_mean, running_var, num_batches_tracked, training: bool,
                     update_stats: bool, eps: float, dtype: torch.dtype, group=None) -> torch.Tensor:
    """BatchNorm2d in plain PyTorch on ``x [N, C, H, W]`` (any memory
    format), in f32 (f64 for an f64 input) and rounded once to ``dtype``.

    Training takes the batch statistics and, with ``update_stats``, moves the
    running ones; eval normalises with the running statistics. With a
    ``group`` each rank's means of x and x^2 are all-reduced in rank order
    and divided by the group's size (every rank holds as many frames), with
    a backward that reaches the other ranks' inputs."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if training:
        mean = x32.mean(dim=_DIMS)
        square = (x32 * x32).mean(dim=_DIMS)
        if group is not None:
            means = all_reduce_sum(torch.stack([mean, square]), group) / group_size(group)
            mean, square = means[0], means[1]
        var = torch.clamp(square - mean * mean, min=0.0)
        if update_stats:
            update_running_stats(running_mean, running_var, num_batches_tracked, mean, var)
    else:
        mean, var = running_mean, running_var
    mul = torch.rsqrt(var + eps) * weight
    y = (x32 - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return y.to(dtype)


def batch_norm_bwd_plain(x, dy, stats, weight, eps: float, training: bool):
    """The kernels' backward in plain PyTorch, ungrouped: ``(dx, dweight,
    dbias)`` for the forward that normalised ``x`` with ``stats [2, C]``:
    ``(E[x], E[x^2])`` of the batch in training, ``(mean, var)`` in eval.

    The channel sums and ``dx`` are taken in f32 (f64 for an f64 input);
    the per-channel terms of ``dx`` in f64, each rounded once, as
    ``csrc/batch_norm.cu`` computes them. ``dE2`` is 0 where the clamp of
    the variance is active (``E[x^2] - E[x]^2 < 0``) and passes where it is
    not, as ``torch.clamp``'s gradient does."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x_, dy_ = x.to(acc), dy.to(acc)
    mean, second = stats[0].to(acc), stats[1].to(acc)
    var_raw = second - mean * mean if training else second
    var = torch.clamp(var_raw, min=0.0) if training else var_raw
    r = 1.0 / torch.sqrt(var + eps)
    mul = r * weight.to(acc)
    s0 = dy_.sum(dim=_DIMS)
    s1 = (dy_ * (x_ - mean[:, None, None])).sum(dim=_DIMS)
    direct = dy_ * mul[:, None, None]
    if training:
        f64 = torch.float64
        n = x.numel() // x.shape[1]
        dvar = -0.5 * s1.to(f64) * weight.to(f64) * r.to(f64) * r.to(f64) * r.to(f64)
        de2 = torch.where(var_raw >= 0, dvar, torch.zeros_like(dvar))
        dmean = -s0.to(f64) * mul.to(f64) - 2.0 * mean.to(f64) * de2
        a, b = (dmean / n).to(acc), (2.0 * de2 / n).to(acc)
        dx = direct + (a[:, None, None] + x_ * b[:, None, None])
    else:
        dx = direct
    return dx.to(x.dtype), s1 * r, s0


def row_vec(c: int, itemsize: int):
    """Channels a thread loads at once over elements of ``itemsize`` bytes:
    16 bytes' worth where C allows, else one; None where C / vec would not
    fit a block's threads (the kernels do not take such a C)."""
    full = 16 // itemsize
    vec = full if c % full == 0 else 1
    return vec if c // vec <= THREADS else None


class Plan(NamedTuple):
    """A call's kernels: channels a load, the reductions' slabs of rows and
    the elementwise passes' blocks (a grid-stride loop over rows)."""

    vec: int
    tiles: int
    blocks: int


def plan(vec: int, rows: int, c: int, sms: int) -> Plan:
    rows_a_pass = THREADS // (c // vec)  # rows one block covers at once
    steps = -(-rows // rows_a_pass)
    return Plan(vec, min(steps, TILES_PER_SM * sms), min(steps, BLOCKS_PER_SM * sms))


def rows_dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` channels-last dense and 16-byte aligned, as the kernels take it
    (a copy where it is not)."""
    if t.is_contiguous(memory_format=torch.channels_last) and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.channels_last)


def check_inputs(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise ValueError on an input the kernels do not take: not ``[N, C, H,
    W]``, empty, not f32 or bf16 (x or the output), C unlike the weights',
    C too wide for a block (:func:`row_vec` of the wider dtype), not on a
    CUDA device."""
    if x.dim() != 4:
        raise ValueError(f"batch_norm takes x [N, C, H, W], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES or dtype not in _DTYPE_CODES:
        raise ValueError(f"batch_norm takes and gives f32 or bf16, got x {x.dtype} and output {dtype}")
    if tuple(weight.shape) != (x.shape[1],):
        raise ValueError(f"batch_norm: x has {x.shape[1]} channels, the weights {tuple(weight.shape)}")
    if x.numel() == 0:
        raise ValueError(f"batch_norm: empty input {tuple(x.shape)}")
    if row_vec(x.shape[1], max(x.element_size(), dtype.itemsize)) is None:
        raise ValueError(f"batch_norm: {x.shape[1]} channels of {x.dtype} and {dtype} do not fit a block of "
                         f"{THREADS} threads")
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm runs on a CUDA device only, got x on {x.device}")


def _check_vectors(device, c: int, **vectors) -> None:
    for name, t in vectors.items():
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"batch_norm: {name} must be a contiguous f32 [{c}] on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a build of ``csrc/batch_norm.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    shape = [ll, i, i, i]  # rows N*H*W, C, vec, tiles or blocks
    lib.bn_stats_launch.argtypes = [p, i, *shape, p, p, p]
    lib.bn_apply_launch.argtypes = [p, i, p, i, *shape, p, p, i, p, p, ctypes.c_float, p, p, p, p]
    lib.bn_bwd_sums_launch.argtypes = [p, p, i, *shape, p, p, p, p]
    lib.bn_dx_launch.argtypes = [p, p, p, i, *shape, p, p, p, ctypes.c_float, p, p, ctypes.c_double, i, p, p, p]
    for fn in (lib.bn_stats_launch, lib.bn_apply_launch, lib.bn_bwd_sums_launch, lib.bn_dx_launch):
        fn.restype = ctypes.c_int
    lib.bn_error_string.argtypes = [ctypes.c_int]
    lib.bn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the BatchNorm kernels' shared library."""
    return bind(ctypes.CDLL(str(kernel_build.build(KERNEL_NAME))))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"batch_norm launch failed: {lib.bn_error_string(err).decode()} (cudaError {err})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def batch_norm(x, weight, bias, running_mean, running_var, num_batches_tracked, *, training: bool,
               update_stats: bool, eps: float, dtype: torch.dtype, group=None):
    """The forward kernels on ``x [N, C, H, W]`` (f32 or bf16, CUDA) ->
    ``(y, stats)``: y in ``dtype``, channels-last, and in training the batch's ``[2, C]`` f32
    ``(E[x], E[x^2])`` (over the group, with a ``group``), None in eval.

    Training: a stats pass and its finalize, the group's all-reduce where
    there is a group, then the apply pass, which with ``update_stats`` also
    moves the running statistics; eval: the apply pass alone, from the
    running statistics. Raises on any input the kernels do not take; never
    computes on another path."""
    check_inputs(x, weight, dtype)
    c = x.shape[1]
    _check_vectors(x.device, c, weight=weight, bias=bias, running_mean=running_mean, running_var=running_var)
    count = num_batches_tracked
    if training and update_stats and (count.device != x.device or count.numel() != 1 or count.dtype != torch.long):
        raise ValueError(f"batch_norm: num_batches_tracked must be one int64 on {x.device}, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}")
    x = rows_dense(x)
    n, _, h, w = x.shape
    pl = plan(row_vec(c, x.element_size()), n * h * w, c, _sms(x.device.index))
    y = torch.empty(x.shape, dtype=dtype, device=x.device, memory_format=torch.channels_last)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        stats, run = None, (None, None, None)
        if training:
            partial = torch.empty(pl.tiles * 2 * c, dtype=torch.float32, device=x.device)
            stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
            _raise_on(lib, lib.bn_stats_launch(x.data_ptr(), _DTYPE_CODES[x.dtype], n * h * w, c, pl.vec, pl.tiles,
                                               partial.data_ptr(), stats.data_ptr(), stream))
            if group is not None:
                stats = reduce_sum(stats, group) / group_size(group)
            mean, second = stats[0], stats[1]
            if update_stats:
                run = (running_mean, running_var, num_batches_tracked)
        else:
            mean, second = running_mean, running_var
        _raise_on(lib, lib.bn_apply_launch(
            x.data_ptr(), _DTYPE_CODES[x.dtype], y.data_ptr(), _DTYPE_CODES[dtype], n * h * w, c, pl.vec, pl.blocks,
            mean.data_ptr(), second.data_ptr(), int(not training), weight.data_ptr(), bias.data_ptr(), eps,
            *map(_ptr, run), stream))
    batch_norm.launches += 1
    return y, stats


batch_norm.launches = 0


def batch_norm_bwd(x, dy, stats, weight, *, eps: float, training: bool, group=None):
    """The backward kernels -> ``(dx, dweight, dbias)`` for the
    forward that normalised ``x`` with ``stats [2, C]`` (:func:`batch_norm`'s
    in training; ``(running_mean, running_var)`` as they were, in eval).

    A sums pass and its finalize give this rank's ``S0`` and ``S1``; with a
    ``group`` they are all-reduced in rank order, and ``dx`` is taken over
    the group's total count, so the gradient reaches the other ranks'
    inputs; dweight and dbias come from this rank's sums. x and dy take
    the wider of their dtypes (exactly), dx is rounded once to x's. Adds
    one to ``batch_norm_bwd.launches`` a call."""
    if dy.shape != x.shape:
        raise ValueError(f"batch_norm_bwd: dy {tuple(dy.shape)} unlike x {tuple(x.shape)}")
    check_inputs(x, weight, dy.dtype)
    c = x.shape[1]
    if stats.shape != (2, c) or stats.dtype != torch.float32 or not stats.is_contiguous():
        raise ValueError(f"batch_norm_bwd: stats must be a contiguous f32 [2, {c}], got {stats.dtype} "
                         f"{tuple(stats.shape)}")
    _check_vectors(x.device, c, weight=weight)
    out_dtype, acc = x.dtype, torch.promote_types(x.dtype, dy.dtype)
    x, dy = rows_dense(x.to(acc)), rows_dense(dy.to(acc))
    n, _, h, w = x.shape
    rows, code = n * h * w, _DTYPE_CODES[acc]
    pl = plan(row_vec(c, x.element_size()), rows, c, _sms(x.device.index))
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial = torch.empty(pl.tiles * 2 * c, dtype=torch.float32, device=x.device)
        local = torch.empty((2, c), dtype=torch.float32, device=x.device)
        _raise_on(lib, lib.bn_bwd_sums_launch(x.data_ptr(), dy.data_ptr(), code, rows, c, pl.vec, pl.tiles,
                                              stats.data_ptr(), partial.data_ptr(), local.data_ptr(), stream))
        sums = local if group is None else reduce_sum(local, group)
        dx = torch.empty(x.shape, dtype=acc, device=x.device, memory_format=torch.channels_last)
        dweight = torch.empty(c, dtype=torch.float32, device=x.device)
        dbias = torch.empty(c, dtype=torch.float32, device=x.device)
        _raise_on(lib, lib.bn_dx_launch(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), code, rows, c, pl.vec, pl.blocks, stats[0].data_ptr(),
            stats[1].data_ptr(), weight.data_ptr(), eps, sums.data_ptr(), local.data_ptr(),
            float(rows * group_size(group)), int(training), dweight.data_ptr(), dbias.data_ptr(), stream))
    batch_norm_bwd.launches += 1
    return dx.to(out_dtype), dweight, dbias


batch_norm_bwd.launches = 0


class _BatchNormFn(torch.autograd.Function):
    """:func:`batch_norm` with :func:`batch_norm_bwd` as its backward; saves
    x in its own dtype and the ``[2, C]`` statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked, training, update_stats, eps,
                dtype, group):
        y, stats = batch_norm(x, weight, bias, running_mean, running_var, num_batches_tracked, training=training,
                              update_stats=update_stats, eps=eps, dtype=dtype, group=group)
        if any(ctx.needs_input_grad[:3]):
            if stats is None:  # eval: the running statistics this call normalised with
                stats = torch.stack([running_mean, running_var])
            ctx.save_for_backward(x, stats, weight)
        ctx.conf = (training, eps, group)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, stats, weight = ctx.saved_tensors
        training, eps, group = ctx.conf
        return batch_norm_bwd(x, dy, stats, weight, eps=eps, training=training, group=group) + (None,) * 8


def batch_norm_2d(x, weight, bias, running_mean, running_var, num_batches_tracked, training: bool,
                  update_stats: bool, eps: float, dtype: torch.dtype, group=None) -> torch.Tensor:
    """BatchNorm2d of ``x [N, C, H, W]``: a CUDA tensor through the kernels
    (differentiable, ``_BatchNormFn``), any other through
    :func:`batch_norm_plain`, with no fallback between them."""
    args = (x, weight, bias, running_mean, running_var, num_batches_tracked, training, update_stats, eps, dtype, group)
    if x.device.type == "cuda":
        return _BatchNormFn.apply(*args)
    return batch_norm_plain(*args)
