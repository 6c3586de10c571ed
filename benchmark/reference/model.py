"""MVDeTr in plain PyTorch, the benchmark's reference.

The architecture of the MVDeTr paper (arXiv 2108.05888) with its repo's
defaults: each camera's frame through a dilated ResNet-18 (output stride
8), a 1x1 bottleneck to 128 channels, per-view heads; the features warped
onto the BEV grid by ``proj @ inv(affine) @ diag(img_reduce)``; the shadow
transformer (``deform_trans``: a stride-2 downsample, three deformable
encoder layers whose levels are the cameras, M=8 heads of D=16, 4 points, a
camera-major merge, a bilinear upsample); BEV heads. Parameter names are the
reference checkpoint's, so one state dict loads here and into the program.

The fusion's attention samples every value map bilinearly (zero outside) at

- ``windowed``: the query's cell plus its offset clamped to ``+-radius``;
- ``gather``: ``reference + offset / [W, H]`` on the rig's reference map,
  unclamped (the paper's semantics).

Everything computes in f32 (no TF32: the caller turns it off on the card).
``precision="fp8"`` is the comparison's control, the step below the bf16
that the configuration states: wherever the configuration rounds to its
compute dtype (each convolution's and linear layer's input, weight, bias
and output, each normalisation's output, residual sums, the warped
features, the resize, the attention weights and embeddings) the value is
rounded to float8 e5m2 instead, as a plain cast (no scale: e5m2 keeps
bf16's range to within its subnormals). No module here imports the
program. ``precision="bf16"`` rounds at the same points to bf16: the
program's precision in the reference, a second witness of its readings.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import geometry

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LOW = {"fp8": torch.float8_e5m2, "bf16": torch.bfloat16}  # the control, and the configuration's own dtype


class Precision:
    """The rounding of the products' operands, shared by every layer of a model."""

    def __init__(self, name: str = "f32"):
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        if self.name not in LOW:
            raise ValueError(f"unknown precision {self.name!r}")
        rounded = x.detach().to(LOW[self.name]).to(x.dtype)
        return x + (rounded - x.detach())  # straight-through: the backward sees the rounded forward


class Conv(nn.Module):
    def __init__(self, prec, cin, cout, k, stride=1, padding=0, dilation=1, bias=True):
        super().__init__()
        self.prec, self.conf = prec, (stride, padding, dilation)
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        q = self.prec
        return q(F.conv2d(q(x), q(self.weight), None if self.bias is None else q(self.bias), *self.conf))


class Linear(nn.Module):
    def __init__(self, prec, fin, fout):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.zeros(fout, fin))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x):
        q = self.prec
        return q(F.linear(q(x), q(self.weight), q(self.bias)))


class BatchNorm(nn.Module):
    """Batch statistics over (N, H, W) in training (biased variance, eps
    1e-5), running statistics at inference; ``calibrate`` makes a training
    forward store its batch statistics as the running ones."""

    def __init__(self, prec, features):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.calibrate = False

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                if self.calibrate:
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
                else:
                    self.running_mean.mul_(0.9).add_(0.1 * mean)
                    self.running_var.mul_(0.9).add_(0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + 1e-5) * self.weight
        return self.prec((x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None])


class Block(nn.Module):
    def __init__(self, prec, cin, cout, stride, dilation, projection):
        super().__init__()
        self.conv1 = Conv(prec, cin, cout, 3, stride, dilation, dilation, bias=False)
        self.bn1 = BatchNorm(prec, cout)
        self.conv2 = Conv(prec, cout, cout, 3, 1, 1, 1, bias=False)
        self.bn2 = BatchNorm(prec, cout)
        self.downsample = (nn.Sequential(Conv(prec, cin, cout, 1, stride, 0, 1, bias=False), BatchNorm(prec, cout))
                           if projection else None)
        self.prec = prec

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(self.prec(y + (x if self.downsample is None else self.downsample(x))))


class MaxPool(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x, 3, stride=2, padding=1)


def resnet18_dilated(prec) -> nn.Sequential:
    """ResNet-18 with layer3 and layer4's strides replaced by dilation 2
    and 4 (only a block's first 3x3 is dilated, the stage's first block at
    the previous stage's dilation)."""
    layers = [Conv(prec, 3, 64, 7, 2, 3, bias=False), BatchNorm(prec, 64), nn.ReLU(), MaxPool()]
    cin, dilation = 64, 1
    for stage, cout in enumerate((64, 128, 256, 512)):
        stride, previous = (1 if stage == 0 else 2), dilation
        if stage >= 2:
            dilation, stride = dilation * 2, 1
        layers.append(nn.Sequential(Block(prec, cin, cout, stride, previous, stride != 1 or cin != cout),
                                    Block(prec, cout, cout, 1, dilation, False)))
        cin = cout
    return nn.Sequential(*layers)


def bilinear(table: torch.Tensor, base: torch.Tensor, x: torch.Tensor, y: torch.Tensor, h: int, w: int,
             weight: torch.Tensor) -> torch.Tensor:
    """``sum`` over the last axis of ``x/y`` of ``weight`` times the bilinear
    sample (pixel i centred at i, each corner outside the ``h x w`` map
    zero) of the maps in ``table [maps*h*w, C]`` that start at rows
    ``base``. Returns ``x.shape[:-1] + (C,)``."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = 0.0
    for dy, dx, wy, wx in ((0, 0, 1 - fy, 1 - fx), (0, 1, 1 - fy, fx), (1, 0, fy, 1 - fx), (1, 1, fy, fx)):
        xc, yc = x0 + dx, y0 + dy
        inside = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
        idx = base + yc.clamp(0, h - 1).long() * w + xc.clamp(0, w - 1).long()
        tap = table.index_select(0, idx.reshape(-1)).view(*idx.shape, table.shape[1])
        out = out + ((torch.where(inside, wy * wx, 0.0) * weight)[..., None] * tap).sum(-2)
    return out


def deformable_sample(value: torch.Tensor, x: torch.Tensor, y: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``value [B, L, H, W, M, D]`` sampled at pixel coordinates ``x/y [B,
    Q, M, L, P]`` and summed with ``weight`` over (L, P): ``[B, Q, M*D]``.
    One level at a time, so that one level's taps are alive at once."""
    b, l, h, w, m, d = value.shape
    q = x.shape[1]
    table = value.permute(0, 4, 1, 2, 3, 5).reshape(b * m * l * h * w, d)  # maps ordered (b, m, l)
    maps = (torch.arange(b, device=x.device).view(b, 1, 1, 1) * m
            + torch.arange(m, device=x.device).view(1, 1, m, 1)) * l
    out = torch.zeros((b, q, m, d), dtype=value.dtype, device=value.device)
    for li in range(l):
        out = out + bilinear(table, (maps + li) * h * w, x[:, :, :, li], y[:, :, :, li], h, w, weight[:, :, :, li])
    return out.reshape(b, q, m * d)


class MSDeformAttn(nn.Module):
    def __init__(self, prec, d_model, n_levels, n_heads, n_points, mode, radius, ref_xy):
        super().__init__()
        self.m, self.l, self.p, self.mode, self.radius = n_heads, n_levels, n_points, mode, radius
        self.prec = prec
        self.value_proj = Linear(prec, d_model, d_model)
        self.sampling_offsets = Linear(prec, d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(prec, d_model, n_heads * n_levels * n_points)
        self.output_proj = Linear(prec, d_model, d_model)
        self.register_buffer("ref_xy", ref_xy, persistent=False)  # gather mode: the map [Q, L, P, 2], normalised

    def coords(self, offsets: torch.Tensor, h: int, w: int):
        """Pixel coordinates ``x, y [B, Q, M, L, P]`` of every sample."""
        q = offsets.shape[1]
        if self.mode == "windowed":
            cell = torch.arange(q, device=offsets.device) % (h * w)
            r = float(self.radius)
            x = (cell % w).float().view(1, q, 1, 1, 1) + offsets[..., 0].clamp(-r, r)
            y = (cell // w).float().view(1, q, 1, 1, 1) + offsets[..., 1].clamp(-r, r)
            return x, y
        ref = self.ref_xy[None, :, None]  # [1, Q, 1, L, P, 2]
        return (ref[..., 0] + offsets[..., 0] / w) * w - 0.5, (ref[..., 1] + offsets[..., 1] / h) * h - 0.5

    def forward(self, query, src, h, w):
        b, q, c = query.shape
        m, l, p = self.m, self.l, self.p
        value = self.value_proj(src).reshape(b, l, h, w, m, c // m)
        offsets = self.sampling_offsets(query).reshape(b, q, m, l, p, 2)
        weight = F.softmax(self.attention_weights(query).reshape(b, q, m, l * p), dim=-1).reshape(b, q, m, l, p)
        weight = self.prec(weight)
        x, y = self.coords(offsets, h, w)
        if value.requires_grad or offsets.requires_grad:
            out = checkpoint(deformable_sample, value, x, y, weight, use_reentrant=False)
        else:
            out = deformable_sample(value, x, y, weight)
        return self.output_proj(self.prec(out))


class Dropout(nn.Module):
    """Elementwise dropout whose mask is drawn from the generator the
    forward is handed: ``rand(shape) >= p`` kept and scaled by ``1/(1-p)``."""

    def __init__(self, p):
        super().__init__()
        self.p = p

    def forward(self, x, generator):
        if generator is None or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


class LayerNorm(nn.LayerNorm):
    """Over the last axis, eps 1e-6, its output rounded as the precision says."""

    def __init__(self, prec, features):
        super().__init__(features, eps=1e-6)
        self.prec = prec

    def forward(self, x):
        return self.prec(super().forward(x))


class EncoderLayer(nn.Module):
    def __init__(self, prec, d_model, d_ffn, dropout, n_levels, n_heads, n_points, mode, radius, ref_xy):
        super().__init__()
        self.self_attn = MSDeformAttn(prec, d_model, n_levels, n_heads, n_points, mode, radius, ref_xy)
        self.prec = prec
        self.dropout1, self.dropout2, self.dropout3 = Dropout(dropout), Dropout(dropout), Dropout(dropout)
        self.norm1 = LayerNorm(prec, d_model)
        self.linear1 = Linear(prec, d_model, d_ffn)
        self.linear2 = Linear(prec, d_ffn, d_model)
        self.norm2 = LayerNorm(prec, d_model)

    def forward(self, src, pos, h, w, generator):
        q = self.prec
        src = self.norm1(q(src + self.dropout1(self.self_attn(q(src + pos), src, h, w), generator)))
        y = self.linear2(self.dropout2(F.relu(self.linear1(src)), generator))
        return self.norm2(q(src + self.dropout3(y, generator)))


class Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class ShadowTransformer(nn.Module):
    """``deform_trans``: the cameras as levels of a deformable encoder on the
    stride-2 BEV grid, merged camera-major, upsampled back."""

    def __init__(self, prec, cfg, rig):
        super().__init__()
        n, c = cfg["num_cam"], cfg["hidden_dim"]
        self.n, self.c, self.prec = n, c, prec
        self.world = tuple(s // cfg["world_reduce"] for s in cfg["worldgrid_shape"])
        self.grid = tuple((s - 1) // 2 + 1 for s in self.world)
        hs, ws = self.grid
        ref = None
        if cfg["attn_mode"] == "gather":
            ref = torch.from_numpy(np.tile(geometry.reference_points(rig, cfg["world_reduce"], 2, cfg["n_points"]),
                                           (n, 1, 1, 1)))
        self.downsample = nn.Sequential(Conv(prec, cfg["bottleneck_dim"], c, 3, 2, 1), nn.ReLU())
        self.lvl_embedding = nn.Parameter(torch.zeros(n, c))
        self.encoder = Encoder([EncoderLayer(prec, c, cfg["dim_feedforward"], cfg["encoder_dropout"], n,
                                             cfg["nhead"], cfg["n_points"], cfg["attn_mode"], cfg["attn_radius"], ref)
                                for _ in range(cfg["enc_layers"])])
        self.merge_linear = nn.Sequential(Conv(prec, n * c, c, 1), nn.ReLU())
        self.upsample = nn.Sequential(nn.Identity(), Conv(prec, c, c, 3, 1, 1), nn.ReLU())
        self.register_buffer("pos", torch.from_numpy(geometry.sine_pos_embedding(hs, ws, c // 2)).reshape(hs * ws, c),
                             persistent=False)
        self.register_buffer("ry", torch.from_numpy(geometry.resize_matrix(hs, self.world[0])), persistent=False)
        self.register_buffer("rx_t", torch.from_numpy(geometry.resize_matrix(ws, self.world[1]).T.copy()),
                             persistent=False)

    def forward(self, x, generator):
        b, n, h, w, c = x.shape
        hs, ws = self.grid
        y = self.downsample(x.reshape(b * n, h, w, c).permute(0, 3, 1, 2))
        src = y.permute(0, 2, 3, 1).reshape(b, n * hs * ws, self.c)
        pos = self.prec(self.pos[None] + self.lvl_embedding[:, None, :]).reshape(1, n * hs * ws, self.c)
        for layer in self.encoder.layers:
            src = layer(src, pos, hs, ws, generator)
        y = src.reshape(b, n, hs, ws, self.c).permute(0, 2, 3, 1, 4).reshape(b, hs, ws, n * self.c)
        y = self.merge_linear(y.permute(0, 3, 1, 2))
        y = self.prec(torch.matmul(self.ry, torch.matmul(y, self.rx_t)))
        return self.upsample(y).permute(0, 2, 3, 1)


class Head(nn.Sequential):
    """A 1x1 projection; NCHW in, NHWC out."""

    def __init__(self, prec, cin, cout):
        super().__init__(Conv(prec, cin, cout, 1))

    def forward(self, x):
        return super().forward(x).permute(0, 2, 3, 1)


class MVDeTr(nn.Module):
    """``forward(imgs [B, N, H, W, 3] uint8, warp [B*N, 2, Hw*Ww])`` ->
    ``((world_heatmap, world_offset), (imgs_heatmap, imgs_offset,
    imgs_wh))``, NHWC logits; ``warp`` holds each view's source pixel
    coordinates (:func:`warp_coords`)."""

    def __init__(self, cfg: dict, rig: dict, precision: str = "f32"):
        super().__init__()
        self.prec = Precision(precision)
        self.cfg, self.rig = cfg, rig
        feat = cfg["bottleneck_dim"]
        self.base = resnet18_dilated(self.prec)
        self.bottleneck = nn.Sequential(Conv(self.prec, 512, feat, 1))
        self.img_heatmap = Head(self.prec, feat, 1)
        self.img_offset = Head(self.prec, feat, 2)
        self.img_wh = Head(self.prec, feat, 2)
        self.world_feat = ShadowTransformer(self.prec, cfg, rig)
        self.world_heatmap = Head(self.prec, feat, 1)
        self.world_offset = Head(self.prec, feat, 2)
        self.world = self.world_feat.world

    def forward(self, imgs: torch.Tensor, warp: torch.Tensor, generator=None):
        b, n, h, w, _ = imgs.shape
        mean = torch.tensor(IMAGENET_MEAN, device=imgs.device) * 255.0
        std = torch.tensor(IMAGENET_STD, device=imgs.device) * 255.0
        x = self.prec((imgs.reshape(b * n, h, w, 3).float() - mean) / std).permute(0, 3, 1, 2)
        feat = self.bottleneck(self.base(x))
        img_outs = tuple(head(feat) for head in (self.img_heatmap, self.img_offset, self.img_wh))
        fh, fw = feat.shape[2:]
        hw, ww = self.world
        table = feat.permute(0, 2, 3, 1).reshape(b * n * fh * fw, -1)
        base = (torch.arange(b * n, device=feat.device) * fh * fw)[:, None, None]
        one = torch.ones(warp.shape[0], warp.shape[2], 1, device=feat.device)
        world_in = bilinear(table, base, warp[:, 0, :, None], warp[:, 1, :, None], fh, fw, one)
        world = self.world_feat(self.prec(world_in).reshape(b, n, hw, ww, -1), generator).permute(0, 3, 1, 2)
        return (self.world_heatmap(world), self.world_offset(world)), img_outs


def warp_coords(cfg: dict, rig: dict, affine_mats: np.ndarray) -> torch.Tensor:
    """``[B*N, 2, Hw*Ww]`` f32: the feature-map pixel that each BEV cell of
    each view samples, through ``inv(proj @ inv(affine) @ diag(img_reduce,
    img_reduce, 1))``, in f64 (a cell whose ray misses the ground plane maps
    far outside the map)."""
    b, n = affine_mats.shape[:2]
    proj = geometry.proj_mats(rig, cfg["world_reduce"])
    reduce = np.diag([cfg["img_reduce"], cfg["img_reduce"], 1.0])
    hw, ww = (s // cfg["world_reduce"] for s in cfg["worldgrid_shape"])
    ys, xs = np.meshgrid(np.arange(hw, dtype=np.float64), np.arange(ww, dtype=np.float64), indexing="ij")
    dst = np.stack([xs.ravel(), ys.ravel(), np.ones(hw * ww)])
    out = np.empty((b * n, 2, hw * ww), dtype=np.float32)
    for i in range(b):
        for cam in range(n):
            mat = proj[cam] @ np.linalg.inv(np.asarray(affine_mats[i, cam], np.float64)) @ reduce
            src = np.linalg.inv(mat) @ dst
            z = np.where(np.abs(src[2]) < 1e-8, np.where(src[2] < 0, -1e-8, 1e-8), src[2])
            out[i * n + cam] = src[:2] / z
    return torch.from_numpy(out)


def radial_offset_bias(n_heads: int, n_levels: int, n_points: int, max_radius=None) -> np.ndarray:
    """Deformable DETR's offset bias: head h's points along direction
    2*pi*h/M, point i on ring i+1 (rings rescaled so the outermost lies on
    ``max_radius`` where given and smaller)."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(n_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    if max_radius is not None and n_points > max_radius:
        grid *= max_radius / n_points
    return grid.reshape(-1).astype(np.float32)


def offset_bias(cfg: dict) -> np.ndarray:
    """The ``sampling_offsets`` bias of the benchmark's initialisation: the
    radial bias, its rings within ``attn_radius`` in windowed mode."""
    radius = cfg["attn_radius"] if cfg["attn_mode"] == "windowed" else None
    return radial_offset_bias(cfg["nhead"], cfg["num_cam"], cfg["n_points"], radius)
