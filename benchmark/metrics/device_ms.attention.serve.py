"""Device milliseconds of the fusion's attention modules (``MSDeformAttn``)
a unit (step or request), forward (and backward in training)."""

from benchmark.harness.trace import layer_seconds


def read(rec, ctx):
    s = layer_seconds(rec, "attention")
    return 1e3 * s / rec["units"] if s > 0 else None
