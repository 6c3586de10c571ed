"""Device milliseconds a step of the normalisation layers (BatchNorm2d and
LayerNorm), forward and backward."""

from benchmark.harness.trace import layer_seconds


def read(rec, ctx):
    s = layer_seconds(rec, "normalisation")
    return 1e3 * s / rec["units"] if s > 0 else None
