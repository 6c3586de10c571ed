"""B3's share of its roofline: the frozen least time of a step's B3 calls
(``benchmark/formulas/warp_bwd.py`` at the calls' shapes) over the device
time of B3's kernels and their memsets, in %."""

from benchmark.harness.trace import layer_seconds


def read(rec, ctx):
    s = layer_seconds(rec, "warp_backward")
    return 100.0 * ctx["b3_least_s"] * rec["units"] / s if s > 0 else None
