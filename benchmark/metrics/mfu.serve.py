"""A request's share of the card's bf16 peak: the frozen reference's
forward FLOPs times the traced requests, over their summed service time, in %."""

from benchmark.formulas.peaks import BF16_FLOP_PER_S


def read(rec, ctx):
    return 100.0 * ctx["flops_per_unit"] * rec["units"] / rec["service_s"] / BF16_FLOP_PER_S
