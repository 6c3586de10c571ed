"""Deformable 2-D convolution (DCNv1, no modulation mask), port of
``mvdetr_tpu/ops/deform_conv.py``.

Contract (the JAX function's)::

    x         [B, H, W, Cin]
    offsets   [B, H, W, K, 2]   (dx, dy) of kernel tap k = ki*kw + kj
    weight    [kh, kw, Cin, Cout]
    bias      [Cout] or None
    out[b, y, x] = sum_k bilinear(x[b], x + (kj - pad_x) + dx_k, y + (ki - pad_y) + dy_k) @ weight[ki, kj] + bias

with ``pad = (k - 1) // 2`` and zero outside the map. The forward is JAX's,
op for op: each tap's coordinates are two additions in the input's dtype in
that order (another order moves ``floor``), the tap is
:func:`~mvdetr_tpu_torch.ops.sampling.bilinear_gather`, and ``out`` adds the
taps' products with the weights in k order, then the bias.
:func:`deform_conv2d_grouped` runs ``G`` such convolutions with their own
weights in one call (the cameras of ``DeformConvWorldFeat``).

The backward (``_DeformConvFn``) has no scatter and no float atomics:

- the input's gradient is the adjoint of bilinear sampling, which is the
  function of the warp backward (TPU kernel B3): each tap's cotangent
  ``g_out @ W_k^T``, all ``K`` taps of all ``G*B`` maps in one
  :func:`~mvdetr_tpu_torch.ops.warp.warp_scatter_accumulate` call (queries
  k-major, ``Q = K*H*W``): on a CUDA tensor ``csrc/warp_bwd.cu``, on a CPU
  tensor the plain ``bilinear_scatter_matmul``;
- the offsets' gradient comes from the corner weights' slopes, as JAX's
  autodiff forms it (``floor`` has zero gradient): per corner ``+-wy`` (x)
  or ``+-wx`` (y) times ``<tap, g_tap>``, masked, summed in f32;
- ``g_weight_k = tap_k^T @ g_out`` from the taps gathered again, and
  ``g_bias = sum g_out``.
"""

from __future__ import annotations

import torch

from mvdetr_tpu_torch.ops.sampling import bilinear_corners, bilinear_gather
from mvdetr_tpu_torch.ops.warp import warp_scatter_accumulate


def tap_coords(offsets: torch.Tensor, kh: int, kw: int, dt: torch.dtype):
    """Pixel coordinates ``sx, sy [N, K, H*W]`` of the taps of ``offsets [N,
    H, W, K, 2]`` (dx, dy): ``(x + (kj - pad_x)) + dx_k`` and likewise in y,
    the JAX function's two additions in its order, the grid in the input's
    dtype ``dt`` and the sum promoted with the offsets'."""
    n, h, w, k, _ = offsets.shape
    if k != kh * kw:
        raise ValueError(f"deform_conv2d: {k} offset taps for a {kh}x{kw} kernel")
    dev = offsets.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dt, device=dev), torch.arange(w, dtype=dt, device=dev),
                            indexing="ij")
    taps = torch.arange(k, device=dev)
    kx = (taps % kw - (kw - 1) // 2).to(dt)
    ky = (taps // kw - (kh - 1) // 2).to(dt)
    off = offsets.reshape(n, h * w, k, 2).permute(0, 2, 1, 3)  # [N, K, H*W, 2]
    sx = (xs.reshape(1, 1, h * w) + kx[None, :, None]) + off[..., 0]
    sy = (ys.reshape(1, 1, h * w) + ky[None, :, None]) + off[..., 1]
    return sx, sy


class _DeformConvFn(torch.autograd.Function):
    """:func:`deform_conv2d_grouped`: ``x [G, B, H, W, Cin]``, ``offsets [G,
    B, H, W, K, 2]``, ``weight [G, kh, kw, Cin, Cout]``, ``bias [G, Cout]``
    or None -> ``[G, B, H, W, Cout]``; products and sums in the promoted
    dtype of ``x`` and ``weight``, as JAX promotes ``tap @ weight``."""

    @staticmethod
    def forward(ctx, x, offsets, weight, bias):
        g, b, h, w, cin = x.shape
        kh, kw, cout = weight.shape[1], weight.shape[2], weight.shape[4]
        sx, sy = tap_coords(offsets.reshape(g * b, h, w, kh * kw, 2), kh, kw, x.dtype)
        dt = torch.promote_types(x.dtype, weight.dtype)
        flat = x.reshape(g * b, h * w, cin)
        out = None
        for k in range(kh * kw):
            tap = bilinear_gather(flat, sx[:, k], sy[:, k], h, w).reshape(g, b * h * w, cin)
            prod = torch.bmm(tap.to(dt), weight[:, k // kw, k % kw].to(dt))
            out = prod if out is None else out + prod
        if bias is not None:
            out = out + bias[:, None, :].to(dt)
        ctx.save_for_backward(x, sx, sy, weight)
        ctx.has_bias = bias is not None
        ctx.offsets_dtype = offsets.dtype
        return out.reshape(g, b, h, w, cout)

    @staticmethod
    def backward(ctx, g_out):
        x, sx, sy, weight = ctx.saved_tensors
        g, b, h, w, cin = x.shape
        kh, kw, cout = weight.shape[1], weight.shape[2], weight.shape[4]
        k_taps = kh * kw
        dt = torch.promote_types(x.dtype, weight.dtype)
        go = g_out.to(dt).reshape(g, b * h * w, cout)
        need_x, need_off, need_w = ctx.needs_input_grad[:3]
        need_b = ctx.has_bias and ctx.needs_input_grad[3]
        flat = x.reshape(g * b, h * w, cin)
        g_taps = torch.empty((g * b, k_taps, h * w, cin), dtype=x.dtype, device=x.device) if need_x else None
        g_w = torch.empty(weight.shape, dtype=dt, device=x.device) if need_w else None
        g_sx = torch.zeros(sx.shape, dtype=torch.float32, device=x.device) if need_off else None
        g_sy = torch.zeros_like(g_sx) if need_off else None
        for k in range(k_taps):
            ki, kj = divmod(k, kw)
            g_tap = torch.bmm(go, weight[:, ki, kj].to(dt).transpose(1, 2)).reshape(g * b, h * w, cin)
            g_tap = g_tap.to(x.dtype)
            if need_x:
                g_taps[:, k] = g_tap
            if not (need_off or need_w):
                continue
            tap = None
            for idx, inb, wyc, wxc, sign_y, sign_x in bilinear_corners(sx[:, k], sy[:, k], h, w):
                corner = torch.gather(flat, 1, idx[..., None].expand(*idx.shape, cin))
                if need_w:
                    contrib = corner * torch.where(inb, wyc * wxc, 0.0).to(x.dtype)[..., None]
                    tap = contrib if tap is None else tap + contrib
                if need_off:
                    t = torch.where(inb, (corner * g_tap).sum(-1), 0.0).float()
                    g_sx[:, k] += sign_x * wyc.float() * t
                    g_sy[:, k] += sign_y * wxc.float() * t
            if need_w:
                g_w[:, ki, kj] = torch.bmm(tap.reshape(g, b * h * w, cin).to(dt).transpose(1, 2), go)
        g_x = g_off = g_bias = None
        if need_x:
            g_x = warp_scatter_accumulate(g_taps.reshape(g * b, k_taps * h * w, cin),
                                          sx.reshape(g * b, -1), sy.reshape(g * b, -1), h, w)
            g_x = g_x.reshape(x.shape)
        if need_off:
            g_off = torch.stack([g_sx, g_sy], -1).permute(0, 2, 1, 3).reshape(g, b, h, w, k_taps, 2)
            g_off = g_off.to(ctx.offsets_dtype)
        if need_b:
            g_bias = go.sum(1)
        if need_w:
            g_w = g_w.to(weight.dtype)
        return g_x, g_off, g_w, g_bias


def deform_conv2d_grouped(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """``G`` deformable convolutions, each with its own weights, in one call:
    ``x [G, B, H, W, Cin]``, ``offsets [G, B, H, W, K, 2]``, ``weight [G,
    kh, kw, Cin, Cout]``, ``bias [G, Cout]`` -> ``[G, B, H, W, Cout]``, each
    group :func:`deform_conv2d` of its own slices. Differentiable in all
    four; the input's gradient is one B3 launch on the card (or raises)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"deform_conv2d: unsupported device {x.device}")
    g, b, h, w, cin = x.shape
    if (weight.dim() != 5 or weight.shape[0] != g or weight.shape[3] != cin or offsets.dim() != 6
            or tuple(offsets.shape[:4]) != (g, b, h, w) or offsets.shape[4] != weight.shape[1] * weight.shape[2]
            or offsets.shape[5] != 2 or (bias is not None and tuple(bias.shape) != (g, weight.shape[4]))):
        raise ValueError(f"deform_conv2d: x {tuple(x.shape)}, offsets {tuple(offsets.shape)}, weight "
                         f"{tuple(weight.shape)} and bias {None if bias is None else tuple(bias.shape)} do not fit")
    return _DeformConvFn.apply(x, offsets, weight, bias)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX function's contract: ``x [B, H, W, Cin]``, ``offsets [B, H,
    W, K, 2]`` (dx, dy), ``weight [kh, kw, Cin, Cout]``, ``bias [Cout]`` ->
    ``[B, H, W, Cout]``."""
    return deform_conv2d_grouped(x[None], offsets[None], weight[None],
                                 None if bias is None else bias[None])[0]
