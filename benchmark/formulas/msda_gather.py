"""Gather attention's sampling (``attn_mode gather``): the same function as
B1 forward and B2 backward, at unclamped coordinates: 10 operations a
sample and channel forward, 30 backward. Bytes: the bf16 value read once,
the f32 locations (2) and bf16 weight (1) of every sample read once, the
bf16 output written once; backward the cotangent read and the three
gradients written once."""

FWD_FLOP_PER_SAMPLE_CHANNEL = 10
BWD_FLOP_PER_SAMPLE_CHANNEL = 30


def flops(samples: int, d: int, backward: bool) -> int:
    return (BWD_FLOP_PER_SAMPLE_CHANNEL if backward else FWD_FLOP_PER_SAMPLE_CHANNEL) * samples * d


def nbytes(value: int, samples: int, outputs: int, backward: bool) -> int:
    fwd = 2 * value + 10 * samples + 2 * outputs
    return fwd + (2 * outputs + 2 * value + 10 * samples if backward else 0)
