"""``attn_mode warped``: the module's work with the shadow warp's resample
(8 operations an entry forward: 4 taps of a multiply and an add), B1's
sampling over the stack of ``L*P`` maps forward, and in training B2's
backward and B3 for the resample's cotangent. The stack lives inside the
module and adds no bytes to its inputs, weights and outputs, so the
roofline reads the same work whatever implements it."""

from benchmark.formulas import attention, msda_windowed_bwd, msda_windowed_fwd, warp_bwd

RESAMPLE_FLOP_PER_ENTRY = 8


def stack_entries(sh: dict) -> int:
    """Entries of the stack: every token's value resampled at its level's
    ``P`` maps, ``b * p * s * m * d``."""
    return sh["b"] * sh["p"] * sh["s"] * sh["m"] * sh["d"]


def sampling_flops(sh: dict, train: bool) -> int:
    n, d, entries = attention.samples(sh), sh["d"], stack_entries(sh)
    fwd = msda_windowed_fwd.flops(n, d) + RESAMPLE_FLOP_PER_ENTRY * entries
    return fwd + (msda_windowed_bwd.flops(n, d) + warp_bwd.flops(entries) if train else 0)


def least_step_seconds(cfg: dict, batch: int, train: bool) -> float:
    return attention.least_step_seconds(attention.shape_of(cfg, batch), train, sampling_flops)


def b3_calls(cfg: dict, batch: int) -> list:
    """B3 as each encoder layer's shadow-warp backward: the stack's
    cotangent onto the ``b * l`` value maps, each map's ``hs * ws * p``
    samples of ``m * d`` channels; ``(cotangent, output, samples)`` entries
    of each call."""
    sh = attention.shape_of(cfg, batch)
    hs, ws = ((s // cfg["world_reduce"] - 1) // 2 + 1 for s in cfg["worldgrid_shape"])
    maps, c = batch * sh["l"], sh["m"] * sh["d"]
    return [(maps * hs * ws * sh["p"] * c, maps * hs * ws * c, maps * hs * ws * sh["p"])] * sh["layers"]
