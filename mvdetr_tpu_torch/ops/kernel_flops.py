"""FLOPs of the hand-written kernels, from the shapes they run at.

PyTorch's ``FlopCounterMode`` sees the library's convolutions and matrix
products, not the kernels launched through ``ctypes``. Their operations are
counted here, one formula a kernel, per sample and channel (the same
formulas give ``chip_smoke.py``'s bounds):

- B1 (``msda_windowed_fwd``): 10 a sample-channel: 4 taps x (multiply +
  add) and the attention weight's multiply-add;
- B2 (``msda_windowed_bwd``): 30 a sample-channel, ~3x B1's (three
  cotangent sums, four value taps); its value side 8 of them (four taps, one
  multiply-add each), its query side the other 22;
- B3 (``warp_bwd``): 12 a (query, channel): 4 taps x (2 multiplies + 1 add);
- gather mode's kernels (``msda_gather_fwd``, ``msda_gather_bwd``): B1's
  function and B2's query side at unclamped coordinates, 10 and 22 (B3
  takes the value side).

A sample is one (query, head, level, point) of the attention weights
``[B, C, H, W, M, L, P]``, a channel one of the head's ``D``.

:func:`record` counts the kernels of the code it wraps, at the shapes they
run at: on a CUDA tensor the launches, on a CPU tensor the calls of their
plain versions, which compute the same function. Given a
``FlopCounterMode``, it also takes the plain versions' own matrix products
out of that count (``excluded``), so the library part is the same on
either device.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field

MSDA_FWD_FLOP_PER_SAMPLE_CHANNEL = 10
MSDA_BWD_FLOP_PER_SAMPLE_CHANNEL = 30
MSDA_BWD_VALUE_FLOP_PER_SAMPLE_CHANNEL = 8
WARP_BWD_FLOP_PER_QUERY_CHANNEL = 12


def msda_fwd_flops(weights_numel: int, d: int) -> int:
    """B1's operations over ``weights_numel`` samples of ``d`` channels."""
    return MSDA_FWD_FLOP_PER_SAMPLE_CHANNEL * weights_numel * d


def msda_bwd_flops(weights_numel: int, d: int) -> int:
    """B2's operations, both sides."""
    return MSDA_BWD_FLOP_PER_SAMPLE_CHANNEL * weights_numel * d


def msda_bwd_value_flops(weights_numel: int, d: int) -> int:
    """B2's value side alone."""
    return MSDA_BWD_VALUE_FLOP_PER_SAMPLE_CHANNEL * weights_numel * d


def warp_bwd_flops(g_numel: int) -> int:
    """B3's operations on a cotangent ``g [B, Q, C]`` of ``g_numel`` entries."""
    return WARP_BWD_FLOP_PER_QUERY_CHANNEL * g_numel


@dataclass
class KernelCalls:
    """What :func:`record` saw: one ``(kernel, shape, flops)`` a call, and
    the library FLOPs the plain versions added to the counter."""

    calls: list = field(default_factory=list)
    excluded: int = 0

    @property
    def flops(self) -> int:
        return sum(f for _, _, f in self.calls)

    def by_kernel(self) -> dict:
        out = {}
        for name, _, f in self.calls:
            calls, flops = out.get(name, (0, 0))
            out[name] = (calls + 1, flops + f)
        return out


@contextlib.contextmanager
def record(counter=None):
    """Count B1, B2, B3 and gather mode's kernels in the code run inside:
    yields a :class:`KernelCalls`. The kernels' dispatch points
    (``msda_windowed._WindowedAttentionFn``, ``msda._GatherAttnFn`` and
    ``warp.warp_scatter_accumulate``)
    look their wrappers and plain versions up in their modules at each call;
    those names are wrapped for the duration. ``counter``: a running
    ``torch.utils.flop_counter.FlopCounterMode`` whose count the plain
    versions' products are taken out of. Launches inside are not added to
    the wrappers' ``launches`` counts."""
    from mvdetr_tpu_torch.ops import msda, msda_windowed, warp

    seen = KernelCalls()

    def counted(module, name, kernel, flops_of):
        inner = getattr(module, name)

        @functools.wraps(inner)  # with its launch counts, which the wrapper's launches then add to
        def call(*args, **kwargs):
            before = counter.get_total_flops() if counter is not None else 0
            out = inner(*args, **kwargs)
            if counter is not None:
                seen.excluded += counter.get_total_flops() - before
            shape, flops = flops_of(*args)
            seen.calls.append((kernel, shape, flops))
            return out

        return call

    def attention(value, offsets, weights, *rest):
        return (tuple(weights.shape), value.shape[-1]), msda_fwd_flops(weights.numel(), value.shape[-1])

    def attention_bwd(value, offsets, weights, *rest):
        return (tuple(weights.shape), value.shape[-1]), msda_bwd_flops(weights.numel(), value.shape[-1])

    def query_side(value, offsets, weights, *rest):
        n, d = weights.numel(), value.shape[-1]
        return (tuple(weights.shape), d), msda_bwd_flops(n, d) - msda_bwd_value_flops(n, d)

    def scatter(g, *rest):
        return tuple(g.shape), warp_bwd_flops(g.numel())

    wrapped = [(msda_windowed, "msda_windowed_fwd", "msda_windowed_fwd", attention),
               (msda_windowed, "ms_deform_attn_windowed", "msda_windowed_fwd", attention),
               (msda_windowed, "msda_windowed_bwd", "msda_windowed_bwd", attention_bwd),
               (msda_windowed, "ms_deform_attn_windowed_bwd", "msda_windowed_bwd", attention_bwd),
               (msda, "msda_gather_fwd", "msda_gather_fwd", attention),
               (msda, "gather_fwd_plain", "msda_gather_fwd", attention),
               (msda, "msda_gather_bwd", "msda_gather_bwd", query_side),
               (msda, "gather_bwd_plain", "msda_gather_bwd", query_side),
               (warp, "warp_bwd", "warp_bwd", scatter),
               (warp, "bilinear_scatter_matmul", "warp_bwd", scatter)]
    saved = [(module, name, getattr(module, name)) for module, name, _, _ in wrapped]
    try:
        for module, name, kernel, flops_of in wrapped:
            setattr(module, name, counted(module, name, kernel, flops_of))
        yield seen
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
