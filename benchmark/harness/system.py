"""The system under test, ``mvdetr_tpu_torch``, through the entry points its
users call: the model built from a rig, ``create_train_state``,
``train_step`` fed by ``prefetch_to_device``, and ``eval_step``. The
benchmark hands it the rig's matrices and the weights it made; nothing else
of the program is used. Each entry is looked up at call time, so a test can
put a broken step in its place."""

from __future__ import annotations

import torch

KERNEL_COUNTERS = (("B1", "mvdetr_tpu_torch.ops.msda_windowed", "msda_windowed_fwd"),
                   ("B2", "mvdetr_tpu_torch.ops.msda_windowed", "msda_windowed_bwd"),
                   ("B3", "mvdetr_tpu_torch.ops.warp", "warp_bwd"),
                   ("BN", "mvdetr_tpu_torch.ops.batch_norm", "batch_norm"),
                   ("BN_bwd", "mvdetr_tpu_torch.ops.batch_norm", "batch_norm_bwd"))


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def build_model(cfg: dict, rig: dict, weights: dict, device) -> torch.nn.Module:
    """The port's ``MVDeTr.from_rig`` on a ``CameraRig`` of the benchmark's
    matrices, with every parameter and statistic replaced by ``weights``."""
    from mvdetr_tpu_torch.geometry import CameraRig
    from mvdetr_tpu_torch.models import MVDeTr

    port_rig = CameraRig(name="bench_rig", num_cam=rig["num_cam"], img_shape=rig["img_shape"],
                         worldgrid_shape=rig["worldgrid_shape"], indexing=rig["indexing"],
                         worldcoord_unit=rig["worldcoord_unit"],
                         worldcoord_from_worldgrid_mat=rig["worldcoord_from_worldgrid"],
                         intrinsic_matrices=rig["intrinsics"], extrinsic_matrices=rig["extrinsics"])
    model = MVDeTr.from_rig(port_rig, world_reduce=cfg["world_reduce"], img_reduce=cfg["img_reduce"],
                            arch=cfg["arch"], world_feat_arch=cfg["world_feat"], bottleneck_dim=cfg["bottleneck_dim"],
                            n_points=cfg["n_points"], compute_dtype=dtype_of(cfg["compute_dtype"]),
                            attn_mode=cfg["attn_mode"], attn_radius=cfg["attn_radius"], dropout=cfg["dropout"],
                            encoder_dropout=cfg["encoder_dropout"], device=device)
    own = model.state_dict()
    if set(own) != set(weights):
        raise RuntimeError(f"weights do not match the program's model: missing {sorted(set(own) - set(weights))[:5]}, "
                           f"unexpected {sorted(set(weights) - set(own))[:5]}")
    model.load_state_dict(weights, strict=True)
    return model


def create_train_state(model, cfg: dict, total_steps: int):
    from mvdetr_tpu_torch.train import create_train_state as create

    return create(model, lr=cfg["lr"], total_steps=total_steps, base_lr_ratio=cfg["base_lr_ratio"],
                  weight_decay=cfg["weight_decay"])


def prefetch_to_device(iterator, device, size: int):
    from mvdetr_tpu_torch.data.prefetch import prefetch_to_device as prefetch

    return prefetch(iterator, device=device, size=size)


def train_step(state, batch: dict, generator, device):
    from mvdetr_tpu_torch.train import train_step as step

    return step(state, batch, generator, device=device)


def eval_step(model, batch: dict, cfg: dict, device):
    from mvdetr_tpu_torch.train import eval_step as step

    return step(model, batch, world_reduce=cfg["world_reduce"], num_candidates=cfg["num_candidates"],
                nms_dist=cfg["nms_dist"], device=device)


def kernel_launches() -> dict:
    """The program's launch counters of its hand-written kernels (B1, B2, B3,
    and the BatchNorm forward and backward): one a call."""
    import importlib

    return {name: getattr(getattr(importlib.import_module(mod), fn), "launches", 0)
            for name, mod, fn in KERNEL_COUNTERS}
