"""The work a step or a request does, counted on the frozen reference: its
convolutions and products by ``FlopCounterMode`` over the configuration's
reference model (:mod:`benchmark.harness.reference`) on the meta device, plus the attention's sampling by the mode's frozen
formula (the counter sees no gathers). The count is the same whatever the
program runs the work with."""

from __future__ import annotations

import importlib

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.formulas import attention, warp_bwd
from benchmark.harness import reference
from benchmark.harness.inputs import input_hw
from benchmark.reference.train import loss_terms


def attention_formula(cfg: dict):
    return importlib.import_module(f"benchmark.formulas.attention_{cfg['attn_mode']}")


def meta_batch(cfg: dict, batch: int) -> dict:
    h, w = input_hw(cfg)
    n, top_k = cfg["num_cam"], cfg["top_k_targets"]
    hw, ww = (s // cfg["world_reduce"] for s in cfg["worldgrid_shape"])
    fh, fw = (-(-s // cfg["img_reduce"]) for s in cfg["img_shape"])

    def gt(shape, lead):
        return {"heatmap": torch.zeros(lead + shape + (1,)), "reg_mask": torch.zeros(lead + (top_k,), dtype=torch.bool),
                "idx": torch.zeros(lead + (top_k,), dtype=torch.long), "offset": torch.zeros(lead + (top_k, 2)),
                "wh": torch.zeros(lead + (top_k, 2))}

    return {"imgs": torch.zeros((batch, n, h, w, 3), dtype=torch.uint8),
            "warp": torch.zeros((batch * n, 2, hw * ww)),
            "world_gt": gt((hw, ww), (batch,)), "imgs_gt": gt((fh, fw), (batch, n))}


def count_flops(cfg: dict, rig: dict, batch: int, train: bool) -> int:
    """FLOPs of one train step (forward, loss, backward) or one request
    (forward) at ``batch`` frame sets."""
    model = reference.of(cfg).MVDeTr(cfg, rig).to("meta")
    with torch.device("meta"):
        data = meta_batch(cfg, batch)
        model.train(train)
        with FlopCounterMode(display=False) as counter:
            if train:
                outputs = model(data["imgs"], data["warp"])  # dropout draws no products
                loss_terms(outputs, data)["loss"].backward()
            else:
                with torch.no_grad():
                    model(data["imgs"], data["warp"])
    sh = attention.shape_of(cfg, batch)
    return counter.get_total_flops() + sh["layers"] * attention_formula(cfg).sampling_flops(sh, train)


def b3_least_seconds(cfg: dict, batch: int) -> float:
    """Least time of a train step's B3 calls: the camera warp's backward
    (bf16 cotangents of every BEV cell of every view onto the feature maps)
    and the attention mode's own calls, where its formula file has a
    ``b3_calls(cfg, batch)`` (``(cotangent, output, samples)`` entries of each
    call, as :mod:`benchmark.formulas.warp_bwd` counts them)."""
    from benchmark.formulas.peaks import least_seconds

    n, c = cfg["num_cam"], cfg["bottleneck_dim"]
    hw, ww = (s // cfg["world_reduce"] for s in cfg["worldgrid_shape"])
    fh, fw = (-(-s // cfg["img_reduce"]) for s in cfg["img_shape"])
    calls = [(batch * n * hw * ww * c, batch * n * fh * fw * c, batch * n * hw * ww)]
    mode_calls = getattr(attention_formula(cfg), "b3_calls", None)
    if mode_calls is not None:
        calls += mode_calls(cfg, batch)
    return sum(least_seconds(warp_bwd.nbytes(g, o, s, 2), 0.0, warp_bwd.flops(g)) for g, o, s in calls)
