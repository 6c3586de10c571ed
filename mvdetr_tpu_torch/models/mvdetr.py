"""MVDeTr, the multiview detector, port of ``mvdetr_tpu/models/mvdetr.py``.

Pipeline (inference):

1. uint8 frames are ImageNet-normalised on the device, in the compute dtype;
2. the dilated ResNet-18 trunk runs over all B*N views, then a 1x1
   bottleneck;
3. per-view heads (center heatmap, sub-cell offset, box size);
4. the per-view features are warped onto the reduced BEV grid by the
   homography ``proj @ inv(affine) @ diag(img_reduce)`` (`mvdetr.py:170-175`);
5. the shadow transformer fuses the cameras;
6. BEV heads: occupancy heatmap and offset.

The public layout is the JAX package's: NHWC images ``[B, N, H, W, 3]`` and
NHWC head outputs. Inside, convolutions run on NCHW-shaped tensors in the
channels-last memory format, which is the same bytes as NHWC.

Compute dtype: parameters stay f32; with ``compute_dtype=torch.bfloat16``
every layer computes in bf16 as the Flax modules do, and head logits and the
attention softmax stay f32.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from mvdetr_tpu_torch.device import resolve_device
from mvdetr_tpu_torch.models.heads import HEATMAP_BIAS_INIT, OutputHead
from mvdetr_tpu_torch.models.layers import Conv2d
from mvdetr_tpu_torch.models.resnet import resnet_features
from mvdetr_tpu_torch.models.world_feat import build_world_feat
from mvdetr_tpu_torch.ops.warp import invert_3x3, perspective_warp

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class MVDeTr(nn.Module):
    """Inference-only in this slice: ``forward`` raises in training mode.

    Submodule names are the reference checkpoint's (``base``,
    ``bottleneck``, ``img_heatmap``, ``img_offset``, ``img_wh``,
    ``world_feat``, ``world_heatmap``, ``world_offset``).
    """

    def __init__(self, num_cam: int, Rworld_shape: Tuple[int, int], img_reduce: int = 12,
                 proj_mats: Optional[np.ndarray] = None, arch: str = "resnet18",
                 world_feat_arch: str = "deform_trans", bottleneck_dim: int = 128, outfeat_dim: int = 0,
                 reference_points: Optional[np.ndarray] = None, n_points: int = 4,
                 compute_dtype: Optional[torch.dtype] = None, attn_mode: str = "auto", attn_radius: int = 4,
                 warp_convention: str = "center", generator: Optional[torch.Generator] = None):
        super().__init__()
        if arch != "resnet18":
            raise NotImplementedError(f"backbone {arch!r} waits for ROADMAP item A8; this slice ports resnet18")
        if warp_convention not in ("center", "kornia"):
            raise ValueError(f"unknown warp_convention: {warp_convention}")
        if proj_mats is None:
            raise ValueError("MVDeTr needs proj_mats [N, 3, 3]")
        self.num_cam = num_cam
        self.Rworld_shape = tuple(int(v) for v in Rworld_shape)
        self.img_reduce = img_reduce
        self.compute_dtype = compute_dtype
        self.warp_convention = warp_convention
        dt = compute_dtype or torch.float32
        g = generator

        self.base = resnet_features(dtype=dt, generator=g)
        feat_dim = 512
        self.bottleneck = None
        if bottleneck_dim:
            self.bottleneck = nn.Sequential(Conv2d(512, bottleneck_dim, 1, dtype=dt, generator=g))
            feat_dim = bottleneck_dim
        self.img_heatmap = OutputHead(feat_dim, 1, outfeat_dim, HEATMAP_BIAS_INIT, dt, g)
        self.img_offset = OutputHead(feat_dim, 2, outfeat_dim, dtype=dt, generator=g)
        self.img_wh = OutputHead(feat_dim, 2, outfeat_dim, dtype=dt, generator=g)
        self.world_feat = build_world_feat(world_feat_arch, num_cam, self.Rworld_shape,
                                           base_dim=bottleneck_dim or 512, reference_points=reference_points,
                                           n_points=n_points, dtype=dt, attn_mode=attn_mode,
                                           attn_radius=attn_radius, generator=g)
        wdim = bottleneck_dim or 512
        self.world_heatmap = OutputHead(wdim, 1, outfeat_dim, HEATMAP_BIAS_INIT, dt, g)
        self.world_offset = OutputHead(wdim, 2, outfeat_dim, dtype=dt, generator=g)
        self.register_buffer("proj_mats", torch.as_tensor(np.asarray(proj_mats), dtype=torch.float32),
                             persistent=False)

    @classmethod
    def from_rig(cls, rig, world_reduce: int = 4, img_reduce: int = 12, arch: str = "resnet18",
                 world_feat_arch: str = "deform_trans", bottleneck_dim: int = 128, outfeat_dim: int = 0,
                 n_points: int = 4, compute_dtype: Optional[torch.dtype] = None, attn_mode: str = "auto",
                 attn_radius: int = 4, warp_convention: str = "center", device="cuda",
                 seed: int = 0) -> "MVDeTr":
        """Build from a :class:`~mvdetr_tpu_torch.geometry.CameraRig`, deriving
        the projection matrices and the reference map (`mvdetr.py:82-95`).

        Weights are drawn from ``torch.Generator().manual_seed(seed)``. The
        model lands on ``device`` (default the card; raises without one unless
        ``device="cpu"``) in eval mode.
        """
        dev = resolve_device(device)
        ref = None
        if world_feat_arch == "deform_trans":
            ref = rig.reference_points(world_reduce=world_reduce, downsample=2, n_points=n_points)
            ref = np.tile(ref, (rig.num_cam, 1, 1, 1))  # queries repeated per camera
            if n_points == 4 and attn_mode != "gather":
                med, p95 = rig.shadow_reach_cells(world_reduce=world_reduce, downsample=2)
                if med > max(15 * attn_radius, 60):
                    warnings.warn(
                        f"rig '{rig.name}': median shadow reach {med:.0f} cells (p95 {p95:.0f}) far "
                        f"exceeds the windowed attention radius {attn_radius} at n_points=4; long-shadow "
                        f"rigs lose accuracy under the clamp"
                    )
        model = cls(
            num_cam=rig.num_cam, Rworld_shape=rig.Rworld_shape(world_reduce), img_reduce=img_reduce,
            proj_mats=rig.proj_mats(world_reduce=world_reduce).astype(np.float32), arch=arch,
            world_feat_arch=world_feat_arch, bottleneck_dim=bottleneck_dim, outfeat_dim=outfeat_dim,
            reference_points=ref, n_points=n_points, compute_dtype=compute_dtype, attn_mode=attn_mode,
            attn_radius=attn_radius, warp_convention=warp_convention,
            generator=torch.Generator().manual_seed(seed),
        )
        return model.to(dev).eval()

    def forward(self, imgs: torch.Tensor, affine_mats: torch.Tensor):
        """``imgs [B, N, H, W, 3]`` (uint8, or float already normalised),
        ``affine_mats [B, N, 3, 3]`` augmentation affines in full-resolution
        pixels -> ``(((world_heatmap, world_offset), (imgs_heatmap,
        imgs_offset, imgs_wh)), offset_clip_fraction per encoder layer)``."""
        if self.training:
            raise NotImplementedError("MVDeTr training (batch statistics, dropout) comes with the training slice")
        b, n, h, w, _ = imgs.shape
        if n != self.num_cam:
            raise ValueError(f"expected {self.num_cam} cameras, got {n}")
        x = imgs.reshape(b * n, h, w, 3)
        if x.dtype == torch.uint8:
            dt = self.compute_dtype or torch.float32
            mean = torch.tensor(IMAGENET_MEAN, dtype=dt, device=x.device) * 255.0
            std = torch.tensor(IMAGENET_STD, dtype=dt, device=x.device) * 255.0
            x = (x.to(dt) - mean) / std
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

        feat = self.base(x)
        if self.bottleneck is not None:
            feat = self.bottleneck(feat)
        imgs_heatmap = self.img_heatmap(feat)
        imgs_offset = self.img_offset(feat)
        imgs_wh = self.img_wh(feat)

        # feature grid -> image px (x img_reduce) -> un-augment -> BEV cell
        proj = self.proj_mats.repeat(b, 1, 1)
        inv_aff = invert_3x3(affine_mats.reshape(b * n, 3, 3).to(device=x.device, dtype=torch.float32))
        reduce_mat = torch.diag(torch.tensor([self.img_reduce, self.img_reduce, 1.0], device=x.device))
        full_proj = proj @ inv_aff @ reduce_mat
        hf, wf = feat.shape[2], feat.shape[3]
        if self.warp_convention == "kornia":
            # kornia's align_corners=False resampling folded into the homography
            # (`mvdetr.py:176-189`): x' = x*W/(W-1) - 0.5 on the source side
            inv_s = torch.tensor(
                [[(wf - 1) / wf, 0.0, 0.5 * (wf - 1) / wf],
                 [0.0, (hf - 1) / hf, 0.5 * (hf - 1) / hf],
                 [0.0, 0.0, 1.0]], dtype=torch.float32, device=x.device)
            full_proj = full_proj @ inv_s

        world_in = perspective_warp(feat.permute(0, 2, 3, 1), full_proj, self.Rworld_shape)
        world_in = world_in.reshape(b, n, self.Rworld_shape[0], self.Rworld_shape[1], -1)
        world_feat, clips = self.world_feat(world_in)
        world_feat = world_feat.permute(0, 3, 1, 2)
        world_heatmap = self.world_heatmap(world_feat)
        world_offset = self.world_offset(world_feat)
        return ((world_heatmap, world_offset), (imgs_heatmap, imgs_offset, imgs_wh)), clips
