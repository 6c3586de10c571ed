"""B2, the windowed attention backward: 30 operations a sample and channel
(three cotangent sums and the four value taps, ~3x B1's), 8 of them the
value side's. Bytes: the bf16 value and the f32 cotangent, offsets and
weights read once; the f32 value gradient and the offsets' and weights'
gradients written once."""

FLOP_PER_SAMPLE_CHANNEL = 30
VALUE_FLOP_PER_SAMPLE_CHANNEL = 8


def flops(samples: int, d: int) -> int:
    return FLOP_PER_SAMPLE_CHANNEL * samples * d


def nbytes(value: int, samples: int, outputs: int) -> int:
    return 2 * value + 4 * (outputs + 3 * samples) + 4 * (value + 3 * samples)
