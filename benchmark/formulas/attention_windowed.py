"""``attn_mode windowed``: the module's work with B1's sampling forward and
B2's backward."""

from benchmark.formulas import attention, msda_windowed_bwd, msda_windowed_fwd


def sampling_flops(sh: dict, train: bool) -> int:
    n = attention.samples(sh)
    return msda_windowed_fwd.flops(n, sh["d"]) + (msda_windowed_bwd.flops(n, sh["d"]) if train else 0)


def least_step_seconds(cfg: dict, batch: int, train: bool) -> float:
    return attention.least_step_seconds(attention.shape_of(cfg, batch), train, sampling_flops)
