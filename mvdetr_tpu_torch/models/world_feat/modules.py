"""BEV multiview fusion, port of ``mvdetr_tpu/models/world_feat/modules.py``:
all five variants, ``[B, N, H, W, C]`` NHWC in, ``([B, H, W, C], clip
fractions)`` out.

- ``ConvWorldFeat`` (``conv``): a stride-2 downsample, the cameras
  concatenated with a coordinate map, a dilated 1/2/4 stack, an upsample;
- ``TransformerWorldFeat`` (``trans``): two stride-2 downsamples, the dense
  encoder of ``models/transformer.py``, two upsamples;
- ``DeformTransWorldFeat`` (``deform_trans``), the shadow transformer, in the
  ``windowed`` mode (the identity reference map of ``n_points=4``), the
  ``warped`` mode (a general map, such as the 8-point shadow map) and the
  ``gather`` mode (the reference semantics);
- ``DeformTransWorldFeatAIO`` (``aio``): the views merged first, a
  single-level ``gather`` encoder;
- ``DeformConvWorldFeat`` (``deform_conv``): a deformable convolution per
  camera (``ops/deform_conv.py``), merged, then the dilated stack.

Parameter names are the reference checkpoint's; only ``deform_trans``
reports clip fractions.

On a mesh whose ``view`` axis splits the cameras, the model gives every
fusion all cameras gathered over ``view`` and it runs replicated, except
``DeformTransWorldFeat`` in ``windowed`` mode: it takes this rank's cameras
and runs the encoder on their query blocks (see the class).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from mvdetr_tpu_torch.models.deformable import DeformableEncoder
from mvdetr_tpu_torch.models.layers import Conv2d, bind_view_axis
from mvdetr_tpu_torch.models.pos_embed import coord_map, sine_pos_embedding
from mvdetr_tpu_torch.models.transformer import TransformerEncoder
from mvdetr_tpu_torch.ops.deform_conv import deform_conv2d_grouped
from mvdetr_tpu_torch.parallel.collectives import gather_cams
from mvdetr_tpu_torch.parallel.mesh import view_shards


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` f32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis (``jax/_src/image/scale.py::compute_weight_mat``, in f32
    as there): the triangle kernel at half-pixel centres, widened by the
    ratio when downsampling (JAX's default antialias), each output's weights
    renormalised over the taps inside the input, and outputs whose centre
    lies outside the input zeroed. For upsampling this is PyTorch's
    ``align_corners=False`` bilinear with its edge clamp."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    dist = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float32)[None, :]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - dist)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0).astype(np.float32)


def _resize_bilinear(x: torch.Tensor, out_hw, mats=None) -> torch.Tensor:
    """NCHW bilinear resize equal to ``jax.image.resize(..., "bilinear")``
    (`mvdetr_tpu/models/world_feat/modules.py:36-38`), as the separable
    product ``y = Ry @ x @ Rx^T`` with the :func:`resize_matrix` weights
    (``mats = (Ry [Ho, Hi], Rx^T [Wi, Wo])`` f32, built when not given).

    Both products run in f32 and the result is cast back to ``x``'s dtype
    once. Its backward is two more matrix products: no scatter and no float
    atomics, so a train step on the card repeats bitwise (PyTorch's
    bilinear ``interpolate`` accumulates its CUDA backward with atomics)."""
    hi, wi = x.shape[-2:]
    if mats is None:
        mats = (torch.from_numpy(resize_matrix(hi, int(out_hw[0]))).to(x.device),
                torch.from_numpy(resize_matrix(wi, int(out_hw[1])).T.copy()).to(x.device))
    ry, rx_t = mats
    if (ry.shape[1], rx_t.shape[0]) != (hi, wi):
        raise ValueError(f"resize matrices take {ry.shape[1]}x{rx_t.shape[0]} inputs, got {hi}x{wi}")
    return torch.matmul(ry, torch.matmul(x.float(), rx_t)).to(x.dtype)  # width first: fewer operations


class _Resize(nn.Module):
    """Bilinear resize from ``in_hw`` to ``out_hw``; the two f32 weight
    matrices are non-persistent buffers (they follow ``.to(device)`` and stay
    out of ``state_dict``, whose names stay the reference's)."""

    def __init__(self, in_hw, out_hw):
        super().__init__()
        self.out_hw = tuple(int(v) for v in out_hw)
        self.register_buffer("ry", torch.from_numpy(resize_matrix(int(in_hw[0]), self.out_hw[0])), persistent=False)
        self.register_buffer("rx_t", torch.from_numpy(resize_matrix(int(in_hw[1]), self.out_hw[1]).T.copy()),
                             persistent=False)

    def forward(self, x):
        return _resize_bilinear(x, self.out_hw, (self.ry, self.rx_t))


def resolve_attn_mode(attn_mode: str, reference_points: Optional[np.ndarray], hs: int, ws: int) -> str:
    """``'auto'`` -> ``'windowed'`` when the reference map is the identity grid
    (the ``n_points=4``, all-z=0 flagship), ``'warped'`` for a general map,
    ``'gather'`` without one (`modules.py:134-149`)."""
    if attn_mode != "auto":
        return attn_mode
    if reference_points is None:
        return "gather"
    ref = np.asarray(reference_points)
    ys, xs = np.meshgrid(np.linspace(0.5, hs - 0.5, hs) / hs,
                         np.linspace(0.5, ws - 0.5, ws) / ws, indexing="ij")
    ident = np.stack([xs, ys], -1).reshape(-1, 2)
    ident = np.tile(ident[None, :, None, None, :],
                    (ref.shape[0] // (hs * ws), 1, ref.shape[1], ref.shape[2], 1)).reshape(ref.shape)
    return "windowed" if np.allclose(ref, ident, atol=1e-3) else "warped"


class DeformTransWorldFeat(nn.Module):
    """The shadow transformer: each camera is one attention level, the queries
    are all N*Hs*Ws cells of the stride-2 BEV grid. ``[B, N, H, W, C]`` NHWC
    in, ``[B, H, W, C]`` NHWC out.

    The attention mode is resolved at construction, from ``reference_points``
    (``[N*Hs*Ws, N, P, 2]``, `models/mvdetr.py:129-130`), since the grid size
    is known from ``world_shape`` already; ``warped`` and ``gather`` modes
    hand the map to the encoder (`modules.py:166-181`).

    ``shards_views``: in ``windowed`` mode on a ``mesh`` whose ``view`` axis
    splits the cameras into V blocks, the input is this rank's ``N / V``
    cameras. The downsample, the tokens (with this rank's rows of
    ``lvl_embedding``) and every encoder layer's value projection, offsets,
    weights, attention over all N levels (each layer gathers the value over
    ``view``), output projection, norms and FFN run on them; the encoder's
    dropouts keep this rank's block of the global mask. After the last
    layer every rank gathers all cameras' tokens
    (:func:`~mvdetr_tpu_torch.parallel.collectives.gather_cams`) and the
    camera-major merge, ``merge_linear``, the upsample and the BEV heads run
    replicated. :meth:`compose_view_shards` runs the V ranks in one process.
    """

    def __init__(self, num_cam: int, world_shape: Tuple[int, int], base_dim: int = 128,
                 hidden_dim: int = 128, nhead: int = 8, dim_feedforward: int = 512, dropout: float = 0.1,
                 n_points: int = 4, stride: int = 2, reference_points: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.float32, attn_mode: str = "auto", attn_radius: int = 4,
                 generator=None, mesh=None):
        super().__init__()
        self.num_cam, self.hidden_dim, self.dtype = num_cam, hidden_dim, dtype
        self.world_shape = tuple(int(v) for v in world_shape)
        # conv 3x3 / stride / pad 1 output size
        self.grid = tuple((s - 1) // stride + 1 for s in self.world_shape)
        self.mode = resolve_attn_mode(attn_mode, reference_points, *self.grid)
        self.downsample = nn.Sequential(
            Conv2d(base_dim, hidden_dim, 3, stride, padding=1, dtype=dtype, init="xavier", generator=generator),
            nn.ReLU(),
        )
        self.lvl_embedding = nn.Parameter(torch.empty(num_cam, hidden_dim))
        with torch.no_grad():
            nn.init.normal_(self.lvl_embedding, 0.0, 1.0, generator=generator)
        self.encoder = DeformableEncoder(3, hidden_dim, dim_feedforward, dropout, num_cam, nhead, n_points, dtype,
                                         self.mode, attn_radius, generator,
                                         reference_points if self.mode in ("warped", "gather") else None, self.grid,
                                         mesh)
        self.shards_views = self.mode == "windowed" and view_shards(mesh, num_cam) > 1
        self.view_group = mesh.group("view") if self.shards_views else None
        self.first_cam = mesh.index("view") * (num_cam // mesh.shape["view"]) if self.shards_views else 0
        self.merge_linear = nn.Sequential(
            Conv2d(num_cam * hidden_dim, hidden_dim, 1, dtype=dtype, init="xavier", generator=generator),
            nn.ReLU(),
        )
        self.upsample = nn.Sequential(
            _Resize(self.grid, self.world_shape),
            Conv2d(hidden_dim, hidden_dim, 3, padding=1, dtype=dtype, init="xavier", generator=generator),
            nn.ReLU(),
        )
        hs, ws = self.grid
        pos = torch.from_numpy(sine_pos_embedding((hs, ws), hidden_dim // 2)).reshape(1, 1, hs * ws, hidden_dim)
        self.register_buffer("pos", pos, persistent=False)

    def bind_view_axis(self, mesh) -> None:
        """Cut the encoder's dropout masks to this rank's tokens (a view
        rank holds its cameras' tokens, axis 1); called by the model after
        binding the data axis."""
        if self.shards_views:
            bind_view_axis(self.encoder, mesh)

    def tokens(self, x: torch.Tensor, first_cam: int = 0):
        """Cameras ``first_cam ..`` of the input, ``x [B, n, H, W, C]`` ->
        ``(tokens [B, n*Hs*Ws, C], their position and level embedding, (Hs, Ws))``."""
        b, n, h, w, c = x.shape
        y = self.downsample(x.reshape(b * n, h, w, c).permute(0, 3, 1, 2))  # NCHW
        hs, ws = y.shape[2], y.shape[3]
        if (hs, ws) != self.grid:
            raise ValueError(f"input grid {h}x{w} does not match world_shape {self.world_shape}")
        tokens = y.permute(0, 2, 3, 1).reshape(b, n * hs * ws, self.hidden_dim)
        lvl = self.lvl_embedding[first_cam:first_cam + n]
        pos_lvl = (self.pos.to(y.dtype) + lvl[None, :, None, :].to(y.dtype))
        return tokens, pos_lvl.reshape(1, n * hs * ws, self.hidden_dim), (hs, ws)

    def merge(self, tokens: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
        """All cameras' tokens ``[B, N*Hs*Ws, C]`` -> ``[B, H, W, C]``."""
        b, n = tokens.shape[0], self.num_cam
        # camera-major merge: [B, N, hs, ws, C] -> [B, hs, ws, N*C] (`modules.py:185`)
        y = tokens.reshape(b, n, hs, ws, self.hidden_dim).permute(0, 2, 3, 1, 4)
        y = y.reshape(b, hs, ws, n * self.hidden_dim).permute(0, 3, 1, 2)
        y = self.upsample(self.merge_linear(y))
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor):
        """Returns ``(y [B, H, W, C], offset_clip_fraction per layer)``; with
        ``shards_views``, ``x`` holds this rank's cameras and the clip
        fractions are its queries' (the caller averages them over ``view``)."""
        tokens, pos_lvl, (hs, ws) = self.tokens(x, self.first_cam)
        tokens, clips = self.encoder(tokens, (hs, ws), pos_lvl)
        if self.shards_views:
            b, c = tokens.shape[0], tokens.shape[2]
            tokens = gather_cams(tokens.reshape(b, x.shape[1], hs * ws, c), self.view_group, dim=1)
            tokens = tokens.reshape(b, self.num_cam * hs * ws, c)
        return self.merge(tokens, hs, ws), clips

    def compose_view_shards(self, x: torch.Tensor, n: int):
        """The forward of ``n`` view ranks (``windowed`` mode, ``n`` dividing
        the cameras) run one after another in one process, on all cameras
        ``x [B, N, H, W, C]``: each rank's cameras, tokens and query blocks
        as on a ``view`` axis of ``n``; each layer's value is every rank's
        :meth:`~mvdetr_tpu_torch.models.deformable.MSDeformAttn.project_value`
        concatenated, which the gather delivers (its gradient is the ranks'
        contributions, added up by autograd). Returns what :meth:`forward`
        returns, the clip fractions averaged over the ranks. Dropout draws
        one rank's masks per call: use it at rate 0 or in eval mode."""
        b, cams = x.shape[:2]
        if self.mode != "windowed" or cams != self.num_cam or cams % n:
            raise ValueError(f"compose_view_shards: {cams} cameras in {self.mode} mode do not split into {n} shards")
        per = cams // n
        shards = [self.tokens(x[:, r * per:(r + 1) * per], r * per) for r in range(n)]
        hs, ws = shards[0][2]
        src = [s[0] for s in shards]
        clips = []
        for layer in self.encoder.layers:
            value = torch.cat([layer.self_attn.project_value(t, (hs, ws)) for t in src], dim=1)
            outs = [layer(t, pos, (hs, ws), value) for t, (_, pos, _) in zip(src, shards)]
            src = [o[0] for o in outs]
            clips.append(torch.stack([o[1] for o in outs]).mean())
        return self.merge(torch.cat(src, dim=1), hs, ws), clips


class DeformTransWorldFeatAIO(nn.Module):
    """Merge the views first, then a single-level deformable encoder
    (`trans_world_feat.py:122-154`, `mvdetr_tpu/models/world_feat/modules.py:194-226`):
    a 1x1 conv over the ``N*C`` camera-major channels, three ``gather``-mode
    encoder layers over the ``H*W`` BEV cells on one level at the standard
    grid reference map (4 points, the radial init unscaled), a 1x1 output
    conv. ``[B, N, H, W, C]`` NHWC in, ``[B, H, W, C]`` NHWC out. The JAX
    module takes no attention mode, radius or point count; neither does
    this one."""

    mode = "gather"

    def __init__(self, num_cam: int, world_shape: Tuple[int, int], base_dim: int = 128, hidden_dim: int = 128,
                 nhead: int = 8, dim_feedforward: int = 512, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.num_cam, self.hidden_dim = num_cam, hidden_dim
        self.world_shape = tuple(int(v) for v in world_shape)
        self.merge = nn.Sequential(
            Conv2d(num_cam * base_dim, hidden_dim, 1, dtype=dtype, init="xavier", generator=generator),
            nn.ReLU(),
        )
        self.encoder = DeformableEncoder(3, hidden_dim, dim_feedforward, dropout, 1, nhead, 4, dtype, "gather",
                                         generator=generator, spatial_shape=self.world_shape)
        self.output = nn.Sequential(
            Conv2d(hidden_dim, hidden_dim, 1, dtype=dtype, init="xavier", generator=generator),
            nn.ReLU(),
        )
        h, w = self.world_shape
        pos = torch.from_numpy(sine_pos_embedding((h, w), hidden_dim // 2)).reshape(1, h * w, hidden_dim)
        self.register_buffer("pos", pos, persistent=False)

    def forward(self, x: torch.Tensor):
        """Returns ``(y [B, H, W, C], [])``: gather mode clamps nothing."""
        b, n, h, w, c = x.shape
        if (h, w) != self.world_shape:
            raise ValueError(f"input grid {h}x{w} does not match world_shape {self.world_shape}")
        # camera-major channels: [B, N, H, W, C] -> [B, H, W, N*C] (`modules.py:208`)
        y = x.permute(0, 2, 3, 1, 4).reshape(b, h, w, n * c).permute(0, 3, 1, 2)
        y = self.merge(y)
        tokens = y.permute(0, 2, 3, 1).reshape(b, h * w, self.hidden_dim)
        tokens, clips = self.encoder(tokens, (h, w), self.pos.to(y.dtype))
        y = tokens.reshape(b, h, w, self.hidden_dim).permute(0, 3, 1, 2)
        return self.output(y).permute(0, 2, 3, 1), clips


def _stride2(hw) -> Tuple[int, int]:
    """Output size of a 3x3 convolution at stride 2 with padding 1."""
    return tuple((int(s) - 1) // 2 + 1 for s in hw)


def _dilated_stack(cin: int, hidden_dim: int, dtype, generator) -> nn.Sequential:
    """Three 3x3 convolutions at dilation 1, 2 and 4, each with a ReLU
    (``world_feat.world_feat.{0,2,4}``, `modules.py:63-68`)."""
    layers = []
    for dil in (1, 2, 4):
        layers += [Conv2d(cin, hidden_dim, 3, padding=dil, dilation=dil, dtype=dtype, generator=generator), nn.ReLU()]
        cin = hidden_dim
    return nn.Sequential(*layers)


class ConvWorldFeat(nn.Module):
    """MVDet's fusion (`mvdetr_tpu/models/world_feat/modules.py:41-75`): a
    3x3 stride-2 downsample with padding (1, 1) per camera, the cameras
    concatenated camera-major with a [-1, 1] coordinate map, the dilated
    stack, a bilinear resize to ``world_shape`` and a 3x3 output conv. The
    JAX module's ``stride`` and ``reduction`` fields, which
    ``build_world_feat`` leaves at 2 and None, are not ported."""

    def __init__(self, num_cam: int, world_shape: Tuple[int, int], base_dim: int = 128, hidden_dim: int = 128,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.world_shape = tuple(int(v) for v in world_shape)
        self.grid = _stride2(self.world_shape)
        self.downsample = nn.Sequential(
            Conv2d(base_dim, hidden_dim, 3, 2, padding=1, dtype=dtype, generator=generator), nn.ReLU())
        self.world_feat = _dilated_stack(num_cam * hidden_dim + 2, hidden_dim, dtype, generator)
        self.upsample = nn.Sequential(
            _Resize(self.grid, self.world_shape),
            Conv2d(hidden_dim, base_dim, 3, padding=1, dtype=dtype, generator=generator), nn.ReLU())
        self.register_buffer("cmap", torch.from_numpy(coord_map(self.grid)).permute(2, 0, 1)[None], persistent=False)

    def forward(self, x: torch.Tensor):
        b, n, h, w, c = x.shape
        y = self.downsample(x.reshape(b * n, h, w, c).permute(0, 3, 1, 2))  # NCHW
        hs, ws = y.shape[2:]
        if (hs, ws) != self.grid:
            raise ValueError(f"input grid {h}x{w} does not match world_shape {self.world_shape}")
        y = y.reshape(b, n * self.hidden_dim, hs, ws)  # camera-major channels (`modules.py:59`)
        y = torch.cat([y, self.cmap.to(y.dtype).expand(b, -1, -1, -1)], 1)
        y = self.upsample(self.world_feat(y))
        return y.permute(0, 2, 3, 1), []


class TransformerWorldFeat(nn.Module):
    """The dense-transformer fusion (`modules.py:78-108`): the cameras
    concatenated camera-major, two 3x3 stride-2 downsamples, the sine
    position embedding, a 3-layer :class:`TransformerEncoder` over the
    quarter-size grid (in f32: the JAX encoder has no dtype), a resize to
    ``ceil(world / 2)``, ``up0``, a resize to ``world_shape``, ``up1``."""

    def __init__(self, num_cam: int, world_shape: Tuple[int, int], base_dim: int = 128, hidden_dim: int = 128,
                 nhead: int = 8, dim_feedforward: int = 512, dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 generator=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.world_shape = tuple(int(v) for v in world_shape)
        self.grid = _stride2(_stride2(self.world_shape))
        mid = tuple(-(-s // 2) for s in self.world_shape)
        self.downsample = nn.Sequential(
            Conv2d(num_cam * base_dim, hidden_dim, 3, 2, padding=1, dtype=dtype, generator=generator), nn.ReLU(),
            Conv2d(hidden_dim, hidden_dim, 3, 2, padding=1, dtype=dtype, generator=generator), nn.ReLU())
        self.encoder = TransformerEncoder(3, hidden_dim, nhead, dim_feedforward, dropout, generator)
        self.upsample = nn.Sequential(
            _Resize(self.grid, mid), Conv2d(hidden_dim, hidden_dim, 3, padding=1, dtype=dtype, generator=generator),
            nn.ReLU(),
            _Resize(mid, self.world_shape),
            Conv2d(hidden_dim, hidden_dim, 3, padding=1, dtype=dtype, generator=generator), nn.ReLU())
        hs, ws = self.grid
        pos = torch.from_numpy(sine_pos_embedding((hs, ws), hidden_dim // 2)).reshape(1, hs * ws, hidden_dim)
        self.register_buffer("pos", pos, persistent=False)

    def forward(self, x: torch.Tensor):
        b, n, h, w, c = x.shape
        y = self.downsample(x.permute(0, 2, 3, 1, 4).reshape(b, h, w, n * c).permute(0, 3, 1, 2))
        hs, ws = y.shape[2:]
        if (hs, ws) != self.grid:
            raise ValueError(f"input grid {h}x{w} does not match world_shape {self.world_shape}")
        tokens = self.encoder(y.permute(0, 2, 3, 1).reshape(b, hs * ws, self.hidden_dim), self.pos.to(y.dtype))
        y = self.upsample(tokens.reshape(b, hs, ws, self.hidden_dim).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1), []


class DeformConvWorldFeat(nn.Module):
    """Per-camera deformable convolution, then a merge
    (`mvdetr_tpu/models/world_feat/modules.py:230-256`): each camera's map
    plus the sine position embedding, a 1x1 conv to the 18 offsets of a 3x3
    kernel, :func:`~mvdetr_tpu_torch.ops.deform_conv.deform_conv2d_grouped`
    (all cameras in one call, so the input's gradient is one B3 launch) and
    a ReLU; the cameras concatenated camera-major, a 1x1 merge and the
    dilated stack.

    Like the JAX module (which has no ``dtype`` field, and adds an f32
    embedding to the maps), everything computes in f32 whatever the model's
    compute dtype. The offsets' parameters keep the reference's layout,
    torchvision's ``DeformConv2d`` one of (dy, dx) per tap
    (``world_feat.deform_pos.{cam}``), and the forward swaps them to the
    op's (dx, dy); the kernels are ``world_feat.deform_conv.{cam}``
    (``[Cout, Cin, 3, 3]``, He-normal as in JAX, zero bias)."""

    def __init__(self, num_cam: int, world_shape: Tuple[int, int], base_dim: int = 128, hidden_dim: int = 128,
                 generator=None):
        super().__init__()
        self.world_shape = tuple(int(v) for v in world_shape)
        self.deform_pos = nn.ModuleList(Conv2d(base_dim, 18, 1, generator=generator) for _ in range(num_cam))
        self.deform_conv = nn.ModuleList(Conv2d(base_dim, base_dim, 3, init="he", generator=generator)
                                         for _ in range(num_cam))
        self.merge_linear = nn.Sequential(Conv2d(num_cam * base_dim, hidden_dim, 1, generator=generator), nn.ReLU())
        self.world_feat = _dilated_stack(hidden_dim, hidden_dim, torch.float32, generator)
        h, w = self.world_shape
        self.register_buffer("pos", torch.from_numpy(sine_pos_embedding((h, w), base_dim // 2)), persistent=False)

    def tap_offsets(self, f: torch.Tensor) -> torch.Tensor:
        """Each camera's offsets ``[N, B, H, W, 9, 2]`` as (dx, dy) per tap,
        from its map plus the embedding ``f [N, B, H, W, C]``."""
        n, b, h, w, _ = f.shape
        return torch.stack([
            conv(f[cam].permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(b, h, w, 9, 2).flip(-1)  # (dy, dx) -> (dx, dy)
            for cam, conv in enumerate(self.deform_pos)])

    def forward(self, x: torch.Tensor):
        b, n, h, w, c = x.shape
        if (h, w) != self.world_shape:
            raise ValueError(f"input grid {h}x{w} does not match world_shape {self.world_shape}")
        f = (x + self.pos).movedim(1, 0)  # [N, B, H, W, C], f32 by promotion as in JAX
        offsets = self.tap_offsets(f)
        weight = torch.stack([conv.weight.permute(2, 3, 1, 0) for conv in self.deform_conv])  # [N, 3, 3, C, Cout]
        bias = torch.stack([conv.bias for conv in self.deform_conv])
        y = torch.relu(deform_conv2d_grouped(f, offsets, weight, bias))  # [N, B, H, W, Cout]
        y = y.permute(1, 2, 3, 0, 4).reshape(b, h, w, -1).permute(0, 3, 1, 2)  # camera-major channels
        y = self.world_feat(self.merge_linear(y))
        return y.permute(0, 2, 3, 1), []


def build_world_feat(arch: str, num_cam: int, world_shape, base_dim: int = 128,
                     reference_points: Optional[np.ndarray] = None, n_points: int = 4,
                     dtype: torch.dtype = torch.float32, attn_mode: str = "auto", attn_radius: int = 4,
                     dropout: float = 0.1, generator=None, mesh=None) -> nn.Module:
    """Variant dispatch (`modules.py:259-284`). Only ``deform_trans`` takes
    the reference map, point count, mode, radius and ``mesh`` (its ``bev``
    axis shards the windowed attention's rows); ``deform_conv`` takes no
    dtype (it computes in f32, as in JAX). ``dropout`` is the encoders' rate
    (``trans``, ``deform_trans``, ``aio``): 0.1 as in the JAX modules, which
    do not expose it."""
    if arch == "conv":
        return ConvWorldFeat(num_cam, world_shape, base_dim, hidden_dim=base_dim, dtype=dtype, generator=generator)
    if arch == "trans":
        return TransformerWorldFeat(num_cam, world_shape, base_dim, hidden_dim=base_dim, dropout=dropout,
                                    dtype=dtype, generator=generator)
    if arch == "deform_conv":
        return DeformConvWorldFeat(num_cam, world_shape, base_dim, hidden_dim=base_dim, generator=generator)
    if arch == "deform_trans":
        return DeformTransWorldFeat(num_cam, world_shape, base_dim, hidden_dim=base_dim, dropout=dropout,
                                    n_points=n_points, reference_points=reference_points, dtype=dtype,
                                    attn_mode=attn_mode, attn_radius=attn_radius, generator=generator, mesh=mesh)
    if arch == "aio":
        return DeformTransWorldFeatAIO(num_cam, world_shape, base_dim, hidden_dim=base_dim, dropout=dropout,
                                       dtype=dtype, generator=generator)
    raise ValueError(f"unknown world_feat arch: {arch}")
