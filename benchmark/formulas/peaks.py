"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit)."""

BF16_FLOP_PER_S = 989e12  # tensor cores, bf16
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3


def least_seconds(nbytes: float, tc_flops: float = 0.0, f32_flops: float = 0.0) -> float:
    """The least time of a piece of work: its bytes at the memory's rate or
    its operations at the peaks (tensor-core products at the bf16 peak, the
    rest at the f32 peak), whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, tc_flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S)
