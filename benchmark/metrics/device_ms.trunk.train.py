"""Device milliseconds a step of the trunk (``model.base``), forward and
backward, outside its normalisation layers."""

from benchmark.harness.trace import layer_seconds


def read(rec, ctx):
    s = layer_seconds(rec, "trunk", minus=("normalisation",))
    return 1e3 * s / rec["units"] if s > 0 else None
