"""The attention modules' share of their roofline: the frozen formula's
least time of their work (``benchmark/formulas/attention_<mode>.py``) over
their device time, in %."""

from benchmark.harness.trace import layer_seconds


def read(rec, ctx):
    s = layer_seconds(rec, "attention")
    return 100.0 * ctx["attention_least_s"] * rec["units"] / s if s > 0 else None
