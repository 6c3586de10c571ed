"""Weights bridges: JAX ``MVDeTr`` variables -> the port's ``state_dict``,
and the reference ``MultiviewDetector.pth`` -> the port's model.

The port names its parameters like the reference ``MultiviewDetector.pth``
that ``mvdetr_tpu/interop.py:134-259`` reads (``base.{0,1,4..7}.*`` of the
ResNet or ``base.{0,3,...,18}`` of VGG-11, ``bottleneck.0``, ``<head>.0``,
and each fusion's ``world_feat.*``), so the published checkpoint loads with
``load_state_dict`` as it is, and
``mvdetr_tpu.interop.convert_reference_state_dict(port.state_dict())`` gives
back the JAX variables this function started from, for every backbone and
fusion variant.

Conversions: conv kernels HWIO -> OIHW, Dense ``[in, out]`` -> Linear
``[out, in]``, BatchNorm/LayerNorm ``scale`` -> ``weight`` with the running
``mean``/``var`` as ``running_mean``/``running_var``, Flax's per-head
query/key/value/out kernels -> ``in_proj_weight`` ``[3C, C]`` and
``out_proj``, and ``deform_conv``'s 18 offset channels from the JAX op's
(dx, dy) per tap back to torchvision's (dy, dx).

The reference checkpoint needs no conversion: :func:`load_torch_checkpoint`
reads it, reads its configuration from its keys
(:func:`detect_reference_config`) and copies it into the model, strictly;
:func:`suggest_attn_radius` picks the windowed clamp radius that covers its
offsets' biases. These three are copied from ``mvdetr_tpu/interop.py:162-227,345-355``.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from mvdetr_tpu_torch.device import resolve_device
from mvdetr_tpu_torch.models.vgg import TORCHVISION_CONV_IDX

_HEADS = ("img_heatmap", "img_offset", "img_wh", "world_heatmap", "world_offset")
# deform_conv's offset channels: (dy, dx) per tap <-> (dx, dy) per tap (`mvdetr_tpu/interop.py:309-325`)
_OFFSET_SWAP = np.arange(18).reshape(9, 2)[:, ::-1].reshape(-1)


def from_jax_variables(variables: dict, device="cuda") -> "OrderedDict[str, torch.Tensor]":
    """``variables``: the JAX ``{"params", "batch_stats"}`` tree of an
    ``MVDeTr`` (either backbone, any fusion variant), as nested dicts of
    arrays (numpy, or anything ``np.asarray`` reads). Returns the port's
    state_dict with tensors on ``device`` (default the card)."""
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

    base = params["base"]
    if "conv0" in base:  # VGG-11: no BatchNorm
        for i, t in enumerate(TORCHVISION_CONV_IDX):
            conv(f"base.{t}", base[f"conv{i}"])
    else:
        sbase = stats["base"]
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

    def layers(node):
        i = 0
        while f"layer{i}" in node:
            yield node[f"layer{i}"], f"world_feat.encoder.layers.{i}"
            i += 1

    def deform_encoder(node):
        for layer, pre in layers(node):
            for proj in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
                dense(f"{pre}.self_attn.{proj}", layer["self_attn"][proj])
            ffn(layer, pre)

    def dense_encoder(node):  # Flax MultiHeadDotProductAttention -> torch nn.MultiheadAttention
        for layer, pre in layers(node):
            attn = layer["self_attn"]
            kernels = [np.asarray(attn[part]["kernel"]) for part in ("query", "key", "value")]  # [C, H, Dh]
            sd[f"{pre}.self_attn.in_proj_weight"] = np.concatenate([k.reshape(k.shape[0], -1).T for k in kernels])
            sd[f"{pre}.self_attn.in_proj_bias"] = np.concatenate(
                [np.asarray(attn[part]["bias"]).reshape(-1) for part in ("query", "key", "value")])
            out = np.asarray(attn["out"]["kernel"])  # [H, Dh, C]
            sd[f"{pre}.self_attn.out_proj.weight"] = out.reshape(-1, out.shape[-1]).T
            sd[f"{pre}.self_attn.out_proj.bias"] = np.asarray(attn["out"]["bias"])
            ffn(layer, pre)

    def ffn(layer, pre):
        norm(f"{pre}.norm1", layer["norm1"])
        dense(f"{pre}.linear1", layer["linear1"])
        dense(f"{pre}.linear2", layer["linear2"])
        norm(f"{pre}.norm2", layer["norm2"])

    def dilated_stack(wf):
        for i, t in enumerate((0, 2, 4)):
            conv(f"world_feat.world_feat.{t}", wf[f"feat{i}"])

    wf = params["world_feat"]
    if "lvl_embedding" in wf:  # deform_trans
        conv("world_feat.downsample.0", wf["downsample"])
        sd["world_feat.lvl_embedding"] = np.asarray(wf["lvl_embedding"])
        deform_encoder(wf["encoder"])
        conv("world_feat.merge_linear.0", wf["merge"])
        conv("world_feat.upsample.1", wf["up"])
    elif "output" in wf:  # aio
        conv("world_feat.merge.0", wf["merge"])
        deform_encoder(wf["encoder"])
        conv("world_feat.output.0", wf["output"])
    elif "down0" in wf:  # trans
        conv("world_feat.downsample.0", wf["down0"])
        conv("world_feat.downsample.2", wf["down1"])
        dense_encoder(wf["encoder"])
        conv("world_feat.upsample.1", wf["up0"])
        conv("world_feat.upsample.4", wf["up1"])
    elif "deform_pos0" in wf:  # deform_conv
        cam = 0
        while f"deform_pos{cam}" in wf:
            pos = wf[f"deform_pos{cam}"]
            conv(f"world_feat.deform_pos.{cam}", {"kernel": np.asarray(pos["kernel"])[..., _OFFSET_SWAP],
                                                  "bias": np.asarray(pos["bias"])[_OFFSET_SWAP]})
            conv(f"world_feat.deform_conv.{cam}", {"kernel": wf[f"deform_weight{cam}"], "bias": wf[f"deform_bias{cam}"]})
            cam += 1
        conv("world_feat.merge_linear.0", wf["merge"])
        dilated_stack(wf)
    elif "out" in wf:  # conv
        conv("world_feat.downsample.0", wf["downsample"])
        dilated_stack(wf)
        conv("world_feat.upsample.1", wf["out"])
    else:
        raise ValueError(f"world_feat parameters {sorted(wf)} are none of the five fusion variants'")
    return OrderedDict((k, torch.from_numpy(np.array(v)).to(dev)) for k, v in sd.items())


def _strip_module(state_dict) -> dict:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in state_dict.items()}


def _count_layers(sd: dict, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def detect_reference_config(state_dict) -> dict:
    """Infer (arch, world_feat_arch, bottleneck_dim, outfeat_dim, num_cam,
    n_points) from a reference state_dict's key structure: the JAX
    function's result, key for key (``num_cam`` and ``n_points`` only where
    it reads them)."""
    sd = _strip_module(state_dict)
    shape = lambda k: tuple(sd[k].shape)  # noqa: E731
    cfg = {}
    cfg["arch"] = "resnet18" if shape("base.0.weight")[2] == 7 else "vgg11"
    cfg["bottleneck_dim"] = int(shape("bottleneck.0.weight")[0]) if "bottleneck.0.weight" in sd else 0
    cfg["outfeat_dim"] = int(shape("img_heatmap.0.weight")[0]) if "img_heatmap.2.weight" in sd else 0
    if "world_feat.lvl_embedding" in sd:
        cfg["world_feat_arch"] = "deform_trans"
        cfg["num_cam"] = int(shape("world_feat.lvl_embedding")[0])
        # sampling_offsets out = heads * levels(=num_cam) * points * 2 (`ms_deform_attn.py:55`); only the
        # product is in the shapes, and the reference hard-wires 8 heads (`trans_world_feat.py:76`)
        off = int(shape("world_feat.encoder.layers.0.self_attn.sampling_offsets.weight")[0])
        nhead = 8
        denom = nhead * cfg["num_cam"] * 2
        if off % denom or not 1 <= off // denom <= 16:
            raise ValueError(
                f"sampling_offsets out-dim {off} is inconsistent with the assumed "
                f"{nhead} attention heads x {cfg['num_cam']} cameras "
                f"(`trans_world_feat.py:76` hard-wires nhead=8); this checkpoint "
                f"was likely trained with a modified nhead — conversion needs a "
                f"matching MSDeformAttn config."
            )
        cfg["n_points"] = off // denom
    elif "world_feat.encoder.layers.0.self_attn.in_proj_weight" in sd:
        cfg["world_feat_arch"] = "trans"
    elif "world_feat.encoder.layers.0.self_attn.value_proj.weight" in sd:
        cfg["world_feat_arch"] = "aio"
    elif "world_feat.deform_conv.0.weight" in sd:
        cfg["world_feat_arch"] = "deform_conv"
        cfg["num_cam"] = _count_layers(sd, "world_feat.deform_conv.{}.weight")
    else:
        cfg["world_feat_arch"] = "conv"
    return cfg


def suggest_attn_radius(state_dict, lo: int = 4, hi: int = 16):
    """The windowed clamp radius for a reference checkpoint, from its
    ``sampling_offsets`` biases: ``ceil(max|b|) + 1``, clamped to
    ``[lo, hi]``. The offsets head is ``W @ query + b`` with ``W``
    zero-initialised, so after training the bias carries the bulk of the
    reach; what ``W`` adds shows in the eval ``offset_clip_fraction`` line.
    B1 takes any radius. Returns ``(radius, max_abs_bias)``."""
    sd = _strip_module(state_dict)
    biases = [v for k, v in sd.items() if k.endswith("sampling_offsets.bias")]
    if not biases:
        return lo, 0.0
    reach = max(float(torch.as_tensor(b).abs().max()) for b in biases)
    return int(min(max(math.ceil(reach) + 1, lo), hi)), reach


def read_torch_checkpoint(path: str) -> dict:
    """A reference ``MultiviewDetector.pth``'s state_dict, on the CPU:
    ``torch.load(weights_only=True)``, unwrapped from ``{"state_dict": ...}``
    and with the ``module.`` prefix of ``DataParallel`` stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd and not any(hasattr(v, "shape") for v in sd.values()):
        sd = sd["state_dict"]
    return _strip_module(sd)


def load_torch_checkpoint(path: str, model: torch.nn.Module, with_config: bool = False):
    """Load the reference ``MultiviewDetector.pth`` at ``path`` into the
    port's ``model``: :func:`read_torch_checkpoint`, then every parameter
    and BatchNorm statistic copied under the checkpoint's own names, strictly
    (a missing, unused or misshapen key raises, as
    ``convert_reference_state_dict(strict=True)`` does). Returns the model,
    and the :func:`detect_reference_config` result when ``with_config``."""
    from mvdetr_tpu_torch.train.state import load_state_dict_checked

    sd = read_torch_checkpoint(path)
    cfg = detect_reference_config(sd)
    load_state_dict_checked(model, sd, what="reference checkpoint")
    return (model, cfg) if with_config else model
