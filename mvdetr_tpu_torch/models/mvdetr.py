"""MVDeTr, the multiview detector, port of ``mvdetr_tpu/models/mvdetr.py``.

Pipeline:

1. uint8 frames are ImageNet-normalised on the device, in the compute dtype;
2. the trunk runs over all B*N views: the dilated ResNet-18 (output stride
   8; in training its BatchNorms take statistics over the B*N views, and
   ``remat_backbone`` rematerialises its blocks) or, with ``arch="vgg11"``,
   VGG-11's features (stride 16, f32 as in JAX); then a 1x1 bottleneck and
   Dropout2d (rate ``dropout``, 0 by default as in JAX);
3. per-view heads (center heatmap, sub-cell offset, box size);
4. the per-view features are warped onto the reduced BEV grid by the
   homography ``proj @ inv(affine) @ diag(img_reduce)`` (`mvdetr.py:170-175`);
5. the BEV fusion (``world_feat_arch``: the shadow transformer
   ``deform_trans`` in ``attn_mode`` windowed, warped or gather, the
   merge-first ``aio``, ``conv``, ``trans`` or ``deform_conv``) fuses the
   cameras (encoder dropout ``encoder_dropout``, 0.1 as in JAX);
6. BEV heads: occupancy heatmap and offset.

With a ``mesh`` (:func:`mvdetr_tpu_torch.parallel.make_mesh`), the model is
one rank's part of the JAX model on that mesh: its BatchNorms take the
statistics of the global batch over the ``data`` axis and its dropout masks
are its block of the global batch's, and the ``deform_trans`` encoder's
windowed attention shards the BEV rows over the ``bev`` axis.

A ``view`` axis that divides the cameras
(:func:`~mvdetr_tpu_torch.parallel.mesh.view_shards`) splits them into V
blocks, as JAX constrains the ``[B*N]`` trunk input and the warped stack to
``("data", "view")`` (`mvdetr_tpu/models/mvdetr.py:144,196`): the model takes
this rank's cameras ``[B, N/V, ...]``, and the trunk (statistics over the
``("data", "view")`` group: JAX's over the global ``B*N``), the bottleneck
and its Dropout2d (this rank's block of the global mask), the per-view
heads and the warp (B3's backward on this rank's cameras) run on them with
their rows of ``proj_mats``. The windowed ``deform_trans`` encoder runs on
their query blocks and gathers the cameras after its last layer
(:class:`~mvdetr_tpu_torch.models.world_feat.modules.DeformTransWorldFeat`);
every other fusion gets the warped stack of all cameras, gathered over
``view`` (:func:`~mvdetr_tpu_torch.parallel.collectives.gather_cams`), and
runs replicated. The BEV heads run replicated on every view rank. A ``view``
axis that does not divide the cameras is idle, as JAX's ``_constrain``
leaves it (`mvdetr.py:222-242`): every view rank runs every camera.
``num_cam`` stays the global count.

The public layout is the JAX package's: NHWC images ``[B, N, H, W, 3]`` and
NHWC head outputs. Inside, convolutions run on NCHW-shaped tensors in the
channels-last memory format, which is the same bytes as NHWC.

Compute dtype: parameters stay f32; with ``compute_dtype=torch.bfloat16``
every layer computes in bf16 as the Flax modules do, and head logits and the
attention softmax stay f32. The modules that JAX builds without a dtype
(VGG-11, the ``trans`` encoder, ``deform_conv``) compute in f32, as Flax's
promotion of a bf16 input against f32 parameters makes them.

With a stride-16 trunk the warp still scales feature pixels by
``img_reduce``, as the JAX model does (`mvdetr.py:169-173`).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from mvdetr_tpu_torch.device import resolve_device
from mvdetr_tpu_torch.models.heads import HEATMAP_BIAS_INIT, OutputHead
from mvdetr_tpu_torch.models.deformable import log_once
from mvdetr_tpu_torch.models.layers import Conv2d, Dropout, bind_data_axis, bind_view_axis
from mvdetr_tpu_torch.models.resnet import resnet_features
from mvdetr_tpu_torch.models.vgg import vgg11_features
from mvdetr_tpu_torch.models.world_feat import build_world_feat
from mvdetr_tpu_torch.ops.warp import invert_3x3, perspective_warp
from mvdetr_tpu_torch.parallel.collectives import gather_cams
from mvdetr_tpu_torch.parallel.mesh import DATA_VIEW, view_shards

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class MVDeTr(nn.Module):
    """``model.train()`` turns on batch statistics and dropout, whose masks
    come from the generator that ``train_step`` sets
    (:func:`~mvdetr_tpu_torch.models.layers.set_dropout_generator`);
    ``model.eval()`` serves.

    Submodule names are the reference checkpoint's (``base``,
    ``bottleneck``, ``img_heatmap``, ``img_offset``, ``img_wh``,
    ``world_feat``, ``world_heatmap``, ``world_offset``).
    """

    def __init__(self, num_cam: int, Rworld_shape: Tuple[int, int], img_reduce: int = 12,
                 proj_mats: Optional[np.ndarray] = None, arch: str = "resnet18",
                 world_feat_arch: str = "deform_trans", bottleneck_dim: int = 128, outfeat_dim: int = 0,
                 reference_points: Optional[np.ndarray] = None, n_points: int = 4,
                 compute_dtype: Optional[torch.dtype] = None, attn_mode: str = "auto", attn_radius: int = 4,
                 warp_convention: str = "center", dropout: float = 0.0, encoder_dropout: float = 0.1,
                 remat_backbone: bool = False, generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        if arch not in ("resnet18", "vgg11"):
            raise ValueError(f"unsupported arch: {arch}")
        if warp_convention not in ("center", "kornia"):
            raise ValueError(f"unknown warp_convention: {warp_convention}")
        if proj_mats is None:
            raise ValueError("MVDeTr needs proj_mats [N, 3, 3]")
        self.num_cam, self.arch = num_cam, arch
        self.Rworld_shape = tuple(int(v) for v in Rworld_shape)
        self.img_reduce = img_reduce
        self.compute_dtype = compute_dtype
        self.warp_convention = warp_convention
        dt = compute_dtype or torch.float32
        g = generator

        # the JAX VGG trunk takes no remat (`mvdetr.py:147-156`)
        self.base = (resnet_features(dtype=dt, remat=remat_backbone, generator=g) if arch == "resnet18"
                     else vgg11_features(generator=g))
        feat_dim = 512
        self.bottleneck = None
        if bottleneck_dim:
            self.bottleneck = nn.Sequential(Conv2d(512, bottleneck_dim, 1, dtype=dt, generator=g))
            feat_dim = bottleneck_dim
        # Dropout2d after the bottleneck: whole channels (`mvdetr.py:161`)
        self.bottleneck_dropout = Dropout(dropout, channels=True)
        self.img_heatmap = OutputHead(feat_dim, 1, outfeat_dim, HEATMAP_BIAS_INIT, dt, g)
        self.img_offset = OutputHead(feat_dim, 2, outfeat_dim, dtype=dt, generator=g)
        self.img_wh = OutputHead(feat_dim, 2, outfeat_dim, dtype=dt, generator=g)
        self.world_feat = build_world_feat(world_feat_arch, num_cam, self.Rworld_shape,
                                           base_dim=bottleneck_dim or 512, reference_points=reference_points,
                                           n_points=n_points, dtype=dt, attn_mode=attn_mode,
                                           attn_radius=attn_radius, dropout=encoder_dropout, generator=g,
                                           mesh=mesh)
        wdim = bottleneck_dim or 512
        self.world_heatmap = OutputHead(wdim, 1, outfeat_dim, HEATMAP_BIAS_INIT, dt, g)
        self.world_offset = OutputHead(wdim, 2, outfeat_dim, dtype=dt, generator=g)
        self.register_buffer("proj_mats", torch.as_tensor(np.asarray(proj_mats), dtype=torch.float32),
                             persistent=False)
        # the view axis: this rank's block of the cameras, or all of them where the axis is idle
        self.view_shards = view_shards(mesh, num_cam)
        self.view_group = mesh.group("view") if self.view_shards > 1 else None
        self.local_cams = num_cam // self.view_shards
        self.first_cam = mesh.index("view") * self.local_cams if self.view_shards > 1 else 0
        if mesh is not None:
            bind_data_axis(self, mesh, DATA_VIEW if self.view_shards > 1 else "data")
        if self.view_shards > 1:
            bind_view_axis(self.bottleneck_dropout, mesh)
            if getattr(self.world_feat, "shards_views", False):
                self.world_feat.bind_view_axis(mesh)
            else:
                log_once(f"view_fusion_{world_feat_arch}",
                         f"mesh has view={self.view_shards}: the trunk, per-view heads and warp run on this rank's "
                         f"{self.local_cams} camera(s); the {world_feat_arch} fusion"
                         f"{'' if world_feat_arch != 'deform_trans' else ' in ' + self.world_feat.mode + ' mode'} "
                         f"runs replicated over view on all {num_cam} cameras (only windowed deform_trans shards "
                         f"its query blocks)")
        elif mesh is not None and mesh.shape["view"] > 1:
            log_once(f"view_idle_{num_cam}_{mesh.shape['view']}",
                     f"mesh has view={mesh.shape['view']} but {num_cam} cameras do not divide over it: every view "
                     f"rank runs every camera, replicated (pick view_shards dividing {num_cam})")

    @classmethod
    def from_rig(cls, rig, world_reduce: int = 4, img_reduce: int = 12, arch: str = "resnet18",
                 world_feat_arch: str = "deform_trans", bottleneck_dim: int = 128, outfeat_dim: int = 0,
                 n_points: int = 4, compute_dtype: Optional[torch.dtype] = None, attn_mode: str = "auto",
                 attn_radius: int = 4, warp_convention: str = "center", dropout: float = 0.0,
                 encoder_dropout: float = 0.1, remat_backbone: bool = False, device="cuda",
                 seed: int = 0, mesh=None) -> "MVDeTr":
        """Build from a :class:`~mvdetr_tpu_torch.geometry.CameraRig`, deriving
        the projection matrices and the reference map (`mvdetr.py:82-95`).
        ``mesh``: this rank's place on a process mesh (see the module's
        docstring).

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
            attn_radius=attn_radius, warp_convention=warp_convention, dropout=dropout,
            encoder_dropout=encoder_dropout, remat_backbone=remat_backbone,
            generator=torch.Generator().manual_seed(seed), mesh=mesh,
        )
        return model.to(dev).eval()

    def warp_mats(self, affine_mats: torch.Tensor, feat_hw) -> torch.Tensor:
        """``[B*N, 3, 3]`` homographies from the feature grid of size
        ``feat_hw`` to the BEV cells: feature px -> image px (x img_reduce) ->
        un-augment -> BEV (`mvdetr.py:170-175`), with kornia's resampling
        folded in under ``warp_convention="kornia"`` (`mvdetr.py:176-189`)."""
        b, n = affine_mats.shape[:2]
        dev = affine_mats.device
        proj = self.proj_mats[self.first_cam:self.first_cam + n].to(dev).repeat(b, 1, 1)
        inv_aff = invert_3x3(affine_mats.reshape(b * n, 3, 3).to(torch.float32))
        reduce_mat = torch.diag(torch.tensor([self.img_reduce, self.img_reduce, 1.0], device=dev))
        full_proj = proj @ inv_aff @ reduce_mat
        if self.warp_convention == "kornia":
            # x' = x*W/(W-1) - 0.5 on the source side
            hf, wf = feat_hw
            inv_s = torch.tensor(
                [[(wf - 1) / wf, 0.0, 0.5 * (wf - 1) / wf],
                 [0.0, (hf - 1) / hf, 0.5 * (hf - 1) / hf],
                 [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
            full_proj = full_proj @ inv_s
        return full_proj

    def forward(self, imgs: torch.Tensor, affine_mats: torch.Tensor):
        """``imgs [B, N, H, W, 3]`` (uint8, or float already normalised),
        ``affine_mats [B, N, 3, 3]`` augmentation affines in full-resolution
        pixels -> ``(((world_heatmap, world_offset), (imgs_heatmap,
        imgs_offset, imgs_wh)), offset_clip_fraction per encoder layer)``.
        On a ``view`` axis that splits the cameras, N is this rank's
        ``num_cam / V`` cameras and the per-view heads are theirs."""
        b, n, h, w, _ = imgs.shape
        if n != self.local_cams:
            raise ValueError(f"expected {self.local_cams} cameras, got {n}")
        x = imgs.reshape(b * n, h, w, 3)
        if x.dtype == torch.uint8:
            dt = self.compute_dtype or torch.float32
            mean = torch.tensor(IMAGENET_MEAN, dtype=dt, device=x.device) * 255.0
            std = torch.tensor(IMAGENET_STD, dtype=dt, device=x.device) * 255.0
            x = (x.to(dt) - mean) / std
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

        feat = self.base(x)
        if self.bottleneck is not None:
            # Dropout2d on [B, N, C, H, W]: its mask is drawn per (frame, camera, channel) of the global batch
            feat = self.bottleneck_dropout(self.bottleneck(feat).unflatten(0, (b, n))).flatten(0, 1)
        imgs_heatmap = self.img_heatmap(feat)
        imgs_offset = self.img_offset(feat)
        imgs_wh = self.img_wh(feat)

        full_proj = self.warp_mats(affine_mats.to(x.device), feat.shape[2:4])
        world_in = perspective_warp(feat.permute(0, 2, 3, 1), full_proj, self.Rworld_shape)
        world_in = world_in.reshape(b, n, self.Rworld_shape[0], self.Rworld_shape[1], -1)
        if self.view_shards > 1 and not getattr(self.world_feat, "shards_views", False):
            world_in = gather_cams(world_in, self.view_group, dim=1)
        world_feat, clips = self.world_feat(world_in)
        world_feat = world_feat.permute(0, 3, 1, 2)
        world_heatmap = self.world_heatmap(world_feat)
        world_offset = self.world_offset(world_feat)
        return ((world_heatmap, world_offset), (imgs_heatmap, imgs_offset, imgs_wh)), clips
