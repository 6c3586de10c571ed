"""``attn_mode gather``: the module's work with gather mode's sampling,
and B3's calls for its value gradient."""

from benchmark.formulas import attention, msda_gather


def sampling_flops(sh: dict, train: bool) -> int:
    n = attention.samples(sh)
    return msda_gather.flops(n, sh["d"], False) + (msda_gather.flops(n, sh["d"], True) if train else 0)


def least_step_seconds(cfg: dict, batch: int, train: bool) -> float:
    return attention.least_step_seconds(attention.shape_of(cfg, batch), train, sampling_flops)


def b3_calls(cfg: dict, batch: int) -> list:
    """B3 as each encoder layer's value gradient: each sample's weighted
    cotangent onto its head and level's map, ``(cotangent, output,
    samples)`` entries of each call."""
    sh = attention.shape_of(cfg, batch)
    hw, ww = (s // cfg["world_reduce"] for s in cfg["worldgrid_shape"])
    maps = batch * sh["m"] * sh["l"]
    hs, ws = ((s - 1) // 2 + 1 for s in (hw, ww))
    per = maps * sh["q"] * sh["p"]
    return [(per * sh["d"], maps * hs * ws * sh["d"], per)] * sh["layers"]
