"""``attn_mode gather``: the module's work with gather mode's sampling."""

from benchmark.formulas import attention, msda_gather


def sampling_flops(sh: dict, train: bool) -> int:
    n = attention.samples(sh)
    return msda_gather.flops(n, sh["d"], False) + (msda_gather.flops(n, sh["d"], True) if train else 0)


def least_step_seconds(cfg: dict, batch: int, train: bool) -> float:
    return attention.least_step_seconds(attention.shape_of(cfg, batch), train, sampling_flops)
