"""B1, the windowed attention forward: per sample (one query, head, level
and point) and channel, 4 taps of a multiply and an add and the weight's
multiply-add: 10 operations. Bytes: the bf16 value read once, the f32
offsets (2) and weight (1) of every sample read once, the f32 output
written once."""

FLOP_PER_SAMPLE_CHANNEL = 10


def flops(samples: int, d: int) -> int:
    return FLOP_PER_SAMPLE_CHANNEL * samples * d


def nbytes(value: int, samples: int, outputs: int) -> int:
    """``value``: value entries; ``samples``: entries of the weights
    ``[B, C, H, W, M, L, P]``; ``outputs``: output entries ``[B, C, H, W, M*D]``."""
    return 2 * value + 4 * (3 * samples + outputs)
