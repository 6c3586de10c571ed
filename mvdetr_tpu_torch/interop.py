"""Weights bridge: JAX ``MVDeTr`` variables -> the port's ``state_dict``.

The port names its parameters like the reference ``MultiviewDetector.pth``
that ``mvdetr_tpu/interop.py:134-259`` reads (``base.{0,1,4..7}.*``,
``bottleneck.0``, ``<head>.0``, ``world_feat.downsample.0``,
``world_feat.lvl_embedding``, ``world_feat.encoder.layers.{i}.*``,
``world_feat.merge_linear.0``, ``world_feat.upsample.1``), so the published
checkpoint loads with ``load_state_dict`` as it is, and
``mvdetr_tpu.interop.convert_reference_state_dict(port.state_dict())`` gives
back the JAX variables this function started from.

Conversions: conv kernels HWIO -> OIHW, Dense ``[in, out]`` -> Linear
``[out, in]``, BatchNorm/LayerNorm ``scale`` -> ``weight`` with the running
``mean``/``var`` as ``running_mean``/``running_var``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from mvdetr_tpu_torch.device import resolve_device

_HEADS = ("img_heatmap", "img_offset", "img_wh", "world_heatmap", "world_offset")
_DEFORM_TRANS_KEYS = {"downsample", "lvl_embedding", "encoder", "merge", "up"}


def from_jax_variables(variables: dict, device="cuda") -> "OrderedDict[str, torch.Tensor]":
    """``variables``: the JAX ``{"params", "batch_stats"}`` tree of a
    ``deform_trans`` ResNet-18 ``MVDeTr``, as nested dicts of arrays (numpy,
    or anything ``np.asarray`` reads). Returns the port's state_dict with
    tensors on ``device`` (default the card)."""
    dev = resolve_device(device)
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()

    def conv(key, node):
        sd[f"{key}.weight"] = np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1))  # HWIO -> OIHW
        if "bias" in node:
            sd[f"{key}.bias"] = np.asarray(node["bias"])

    def dense(key, node):
        sd[f"{key}.weight"] = np.asarray(node["kernel"]).T
        sd[f"{key}.bias"] = np.asarray(node["bias"])

    def norm(key, node):
        sd[f"{key}.weight"] = np.asarray(node["scale"])
        sd[f"{key}.bias"] = np.asarray(node["bias"])

    def batchnorm(key, pnode, snode):
        norm(key, pnode)
        sd[f"{key}.running_mean"] = np.asarray(snode["mean"])
        sd[f"{key}.running_var"] = np.asarray(snode["var"])
        sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)

    base, sbase = params["base"], stats["base"]
    conv("base.0", base["conv1"])
    batchnorm("base.1", base["bn1"], sbase["bn1"])
    for stage in range(1, 5):
        block = 0
        while f"layer{stage}_{block}" in base:
            name, pre = f"layer{stage}_{block}", f"base.{3 + stage}.{block}"
            blk, sblk = base[name], sbase[name]
            conv(f"{pre}.conv1", blk["conv1"])
            batchnorm(f"{pre}.bn1", blk["bn1"], sblk["bn1"])
            conv(f"{pre}.conv2", blk["conv2"])
            batchnorm(f"{pre}.bn2", blk["bn2"], sblk["bn2"])
            if "downsample_conv" in blk:
                conv(f"{pre}.downsample.0", blk["downsample_conv"])
                batchnorm(f"{pre}.downsample.1", blk["downsample_bn"], sblk["downsample_bn"])
            block += 1

    if "bottleneck" in params:
        conv("bottleneck.0", params["bottleneck"])
    for head in _HEADS:
        node = params[head]
        if "neck" in node:
            conv(f"{head}.0", node["neck"])
            conv(f"{head}.2", node["proj"])
        else:
            conv(f"{head}.0", node["proj"])

    wf = params["world_feat"]
    if set(wf) != _DEFORM_TRANS_KEYS:
        raise NotImplementedError(
            f"world_feat parameters {sorted(wf)} are not the shadow transformer's; the other "
            "variants wait for ROADMAP item A8"
        )
    conv("world_feat.downsample.0", wf["downsample"])
    sd["world_feat.lvl_embedding"] = np.asarray(wf["lvl_embedding"])
    i = 0
    while f"layer{i}" in wf["encoder"]:
        layer, pre = wf["encoder"][f"layer{i}"], f"world_feat.encoder.layers.{i}"
        for proj in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
            dense(f"{pre}.self_attn.{proj}", layer["self_attn"][proj])
        norm(f"{pre}.norm1", layer["norm1"])
        dense(f"{pre}.linear1", layer["linear1"])
        dense(f"{pre}.linear2", layer["linear2"])
        norm(f"{pre}.norm2", layer["norm2"])
        i += 1
    conv("world_feat.merge_linear.0", wf["merge"])
    conv("world_feat.upsample.1", wf["up"])
    return OrderedDict((k, torch.from_numpy(np.array(v)).to(dev)) for k, v in sd.items())
