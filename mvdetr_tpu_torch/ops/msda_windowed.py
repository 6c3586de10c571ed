"""Windowed deformable attention, port of ``mvdetr_tpu/ops/msda_windowed.py``.

In the flagship configuration (``n_points=4``) the reference map is the
identity grid, so each sample sits at its query's BEV cell plus a learned
offset, clamped to ``+-radius`` cells. Three pieces live here:

- :func:`ms_deform_attn_windowed`, the plain PyTorch version: a 4-tap
  bilinear gather at the clamped offset, zero outside the grid, summed in
  f32. The CPU path and the tests use it.
- :func:`msda_windowed_fwd`, the wrapper of the hand-written CUDA kernel
  ``csrc/msda_windowed_fwd.cu`` (it replaces the TPU kernel
  ``mvdetr_tpu/ops/pallas/msda_kernel.py::_kernel``). It counts its launches
  in ``msda_windowed_fwd.launches``.
- :func:`windowed_attention`, the dispatch: a CPU tensor goes to the plain
  version, a CUDA tensor to the kernel, with no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mvdetr_tpu_torch.ops import kernel_build

KERNEL_NAME = "msda_windowed_fwd"
_SMEM_LIMIT = 232448  # dynamic shared memory one Hopper block may use


def ms_deform_attn_windowed(
    value: torch.Tensor,  # [B, L, H, W, M, D]
    offsets: torch.Tensor,  # [B, C, H, W, M, L, P, 2] raw offsets in cells (x, y)
    weights: torch.Tensor,  # [B, C, H, W, M, L, P]
    radius: int = 4,
    flatten: bool = True,
) -> torch.Tensor:
    """Plain version: ``[B, C*H*W, M*D]`` f32 (``[B, C, H, W, M*D]`` when
    ``flatten=False``).

    The JAX function sums (2R+1)^2 shifted windows with hat weights; for an
    offset clamped to ``+-radius`` that sum is exactly the bilinear gather
    written here. It loops over the L*P samples so that it holds one
    ``[B, C, H, W, M, D]`` gather at a time, and uses the kernel's
    arithmetic: the fraction comes from the clamped offset itself, and the
    taps are blended as ``(1-fy)*((1-fx)*v00 + fx*v01) + fy*(...)``.
    """
    b, l, h, w, m, d = value.shape
    c, p = offsets.shape[1], offsets.shape[6]
    dev = value.device
    r = float(radius)
    # rows ordered (b, l, m, y, x) so one flat index addresses a tap
    v = value.float().permute(0, 1, 4, 2, 3, 5).reshape(b * l * m * h * w, d)
    off = offsets.float()
    wgt = weights.float()
    xs = torch.arange(w, device=dev).view(1, 1, 1, w, 1)
    ys = torch.arange(h, device=dev).view(1, 1, h, 1, 1)
    bm = (torch.arange(b, device=dev).view(b, 1, 1, 1, 1) * l * m
          + torch.arange(m, device=dev).view(1, 1, 1, 1, m))  # (b*L + 0)*M + m
    acc = torch.zeros((b, c, h, w, m, d), dtype=torch.float32, device=dev)
    for li in range(l):
        for pi in range(p):
            ox = off[:, :, :, :, :, li, pi, 0].clamp(-r, r)
            oy = off[:, :, :, :, :, li, pi, 1].clamp(-r, r)
            ix = torch.floor(ox)
            iy = torch.floor(oy)
            fx = (ox - ix)[..., None]
            fy = (oy - iy)[..., None]
            x0 = xs + ix.long()
            y0 = ys + iy.long()
            taps = []
            for dy in (0, 1):
                for dx in (0, 1):
                    yy, xx = y0 + dy, x0 + dx
                    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                    row = ((bm + li * m) * h + yy.clamp(0, h - 1)) * w + xx.clamp(0, w - 1)
                    tap = v.index_select(0, row.reshape(-1)).view(b, c, h, w, m, d)
                    taps.append(tap * ok[..., None])
            top = (1.0 - fx) * taps[0] + fx * taps[1]
            bot = (1.0 - fx) * taps[2] + fx * taps[3]
            acc += wgt[:, :, :, :, :, li, pi, None] * ((1.0 - fy) * top + fy * bot)
    out = acc.reshape(b, c, h, w, m * d)
    return out.reshape(b, c * h * w, m * d) if flatten else out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    lib = ctypes.CDLL(str(kernel_build.build(KERNEL_NAME)))
    lib.msda_windowed_fwd_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.msda_windowed_fwd_launch.restype = ctypes.c_int
    lib.msda_windowed_fwd_error_string.argtypes = [ctypes.c_int]
    lib.msda_windowed_fwd_error_string.restype = ctypes.c_char_p
    return lib


def msda_windowed_fwd(value: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor,
                      radius: int) -> torch.Tensor:
    """Launch the CUDA kernel: ``value [B, L, H, W, M, D]`` bf16, raw
    ``offsets [B, C, H, W, M, L, P, 2]`` f32 and ``weights [B, C, H, W, M, L, P]``
    f32, all contiguous on one CUDA device -> ``[B, C, H, W, M*D]`` f32.

    Raises on any input the kernel does not take; never computes on another
    path. Adds one to ``msda_windowed_fwd.launches`` per launch."""
    if value.device.type != "cuda":
        raise ValueError(f"msda_windowed_fwd runs on a CUDA device only, got value on {value.device}")
    for name, t in (("offsets", offsets), ("weights", weights)):
        if t.device != value.device:
            raise ValueError(f"msda_windowed_fwd: {name} on {t.device}, value on {value.device}")
    if value.dtype != torch.bfloat16 or offsets.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError("msda_windowed_fwd takes a bf16 value and f32 offsets and weights, got "
                         f"{value.dtype}, {offsets.dtype}, {weights.dtype}")
    if value.dim() != 6 or offsets.dim() != 8 or weights.dim() != 7:
        raise ValueError("msda_windowed_fwd: value must be 6-D, offsets 8-D and weights 7-D")
    b, l, h, w, m, d = value.shape
    c, p = offsets.shape[1], offsets.shape[6]
    if tuple(offsets.shape) != (b, c, h, w, m, l, p, 2) or tuple(weights.shape) != (b, c, h, w, m, l, p):
        raise ValueError(f"msda_windowed_fwd: shapes do not fit value {tuple(value.shape)}: offsets "
                         f"{tuple(offsets.shape)}, weights {tuple(weights.shape)}")
    if not (value.is_contiguous() and offsets.is_contiguous() and weights.is_contiguous()):
        raise ValueError("msda_windowed_fwd: inputs must be contiguous")
    k = m * d
    if not 0 < k <= 1024:
        raise ValueError(f"msda_windowed_fwd: M*D = {k} must be in [1, 1024]")
    if int(radius) != radius or radius < 0:
        raise ValueError(f"msda_windowed_fwd: radius must be a non-negative integer, got {radius}")
    if max(1, 256 // k) * m * l * p * 3 * 4 > _SMEM_LIMIT:
        raise ValueError(f"msda_windowed_fwd: M*L*P = {m * l * p} needs more shared memory than a block has")
    out = torch.empty((b, c, h, w, k), dtype=torch.float32, device=value.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        err = lib.msda_windowed_fwd_launch(
            value.data_ptr(), offsets.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, c, l, h, w, m, d, p, int(radius), stream,
        )
    if err != 0:
        msg = lib.msda_windowed_fwd_error_string(err).decode()
        raise RuntimeError(f"msda_windowed_fwd launch failed: {msg} (cudaError {err})")
    msda_windowed_fwd.launches += 1
    return out


msda_windowed_fwd.launches = 0


class _WindowedAttentionFn(torch.autograd.Function):
    """The kernel behind autograd: forward only in the serving slice."""

    @staticmethod
    def forward(ctx, value, offsets, weights, radius):
        return msda_windowed_fwd(value, offsets, weights, radius)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "windowed attention has no CUDA backward yet: the backward kernel (B2, "
            "mvdetr_tpu/ops/pallas/msda_kernel_bwd.py::_bwd_kernel) comes with the training slice"
        )


def windowed_attention(value, offsets, weights, radius: int = 4, row_halo: bool = False,
                       flatten: bool = True) -> torch.Tensor:
    """Windowed deformable attention with device dispatch; the same contract
    as :func:`ms_deform_attn_windowed`.

    A CUDA tensor runs the kernel on the inputs staged as the TPU path stages
    them (value cast to bf16, offsets and weights to f32); a CPU tensor runs
    the plain version on the inputs as given.
    """
    if row_halo:
        raise NotImplementedError("row_halo (BEV-row sharding) waits for the multi-GPU slice (ROADMAP A9)")
    if value.device.type == "cuda":
        out = _WindowedAttentionFn.apply(
            value.to(torch.bfloat16).contiguous(),
            offsets.to(torch.float32).contiguous(),
            weights.to(torch.float32).contiguous(),
            radius,
        )
    elif value.device.type == "cpu":
        out = ms_deform_attn_windowed(value, offsets, weights, radius, flatten=False)
    else:
        raise ValueError(f"windowed_attention: unsupported device {value.device}")
    b, c, h, w, k = out.shape
    return out.reshape(b, c * h * w, k) if flatten else out
