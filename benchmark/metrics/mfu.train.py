"""The train step's share of the card's bf16 peak: the frozen reference's
FLOPs of a step times the traced steps, over the traced window, in %."""

from benchmark.formulas.peaks import BF16_FLOP_PER_S


def read(rec, ctx):
    return 100.0 * ctx["flops_per_unit"] * rec["units"] / rec["window_s"] / BF16_FLOP_PER_S
