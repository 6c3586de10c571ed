"""Windowed deformable attention (TPU kernel B1): the port's plain version
against the JAX XLA op and the Pallas kernel in interpret mode, on the same
numpy inputs. The CUDA kernel is held against the plain version on the card
by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.

Tolerances: f32 inputs, f32 sums in another order on each side, outputs of
order 1 -> atol 2e-5 (observed ~4e-7)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvdetr_tpu.models.deformable import radial_offset_bias as jax_radial_offset_bias
from mvdetr_tpu.ops.msda_windowed import ms_deform_attn_windowed as jax_windowed
from mvdetr_tpu.ops.pallas.msda_kernel import msda_windowed_pallas
from mvdetr_tpu_torch.models.deformable import radial_offset_bias
from mvdetr_tpu_torch.ops.msda_windowed import (
    _fwd_plan,
    ms_deform_attn_windowed,
    msda_windowed_fwd,
    windowed_attention,
)
from _torch_port import windowed_inputs

ATOL = 2e-5


def _jax_pair(value, off, wgt, radius, kernel_dtype=jnp.float32):
    """(XLA op, Pallas kernel in interpret mode), both ``[B, C, H, W, M*D]``."""
    b, c, h, w = off.shape[:4]
    k = value.shape[-2] * value.shape[-1]
    xla = np.asarray(jax_windowed(jnp.asarray(value), jnp.asarray(off), jnp.asarray(wgt), radius))
    pallas = np.asarray(msda_windowed_pallas(jnp.asarray(value), jnp.asarray(off), jnp.asarray(wgt), radius,
                                             kernel_dtype=kernel_dtype, interpret=True))
    return xla.reshape(b, c, h, w, k), pallas


def _port(value, off, wgt, radius):
    return ms_deform_attn_windowed(torch.as_tensor(value), torch.from_numpy(off), torch.from_numpy(wgt),
                                   radius, flatten=False).numpy()


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_plain_matches_jax_random_offsets_past_the_clamp(radius, rng):
    """Offsets up to 1.5 cells beyond +-R bind the clamp; W=20 and H=7
    divide by neither 8 nor the TPU row tile."""
    value, off, wgt = windowed_inputs(rng, 2, 3, 7, 20, 8, 16, 4, 3, -radius - 1.5, radius + 1.5)
    assert (np.abs(off) > radius).mean() > 0.1
    xla, pallas = _jax_pair(value, off, wgt, radius)
    ours = _port(value, off, wgt, radius)
    np.testing.assert_allclose(ours, xla, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


def test_plain_matches_jax_integer_offsets(rng):
    """The radial init at max_radius=4 is mostly exact integers (81% at 8
    heads, 7 levels, 4 points); shifted by random integers, some land on
    the clamp and beyond it. At an integer offset a tap weight is exactly 0
    or 1 on both sides."""
    b, l, h, w, m, d, p, c, radius = 1, 7, 6, 12, 8, 16, 4, 2, 4
    bias = radial_offset_bias(m, l, p, max_radius=radius)
    np.testing.assert_array_equal(bias, jax_radial_offset_bias(m, l, p, max_radius=radius))
    assert np.mean(bias == np.round(bias)) > 0.8
    value, _, wgt = windowed_inputs(rng, b, l, h, w, m, d, p, c, 0, 1)
    shift = rng.integers(-2, 3, (b, c, h, w, m, l, p, 2))
    off = (bias.reshape(m, l, p, 2) + shift).astype(np.float32)
    xla, pallas = _jax_pair(value, off, wgt, radius)
    ours = _port(value, off, wgt, radius)
    np.testing.assert_allclose(ours, xla, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


@pytest.mark.parametrize("radius", [1, 4])
def test_plain_matches_jax_offsets_on_the_clamp(radius, rng):
    """Offsets of exactly +-R (and 0, and far beyond): the outermost ring
    samples with a zero-weight corner at R+1, which must stay zero."""
    b, l, h, w, m, d, p, c = 1, 2, 6, 10, 8, 16, 3, 2
    value, _, wgt = windowed_inputs(rng, b, l, h, w, m, d, p, c, 0, 1)
    choices = np.array([-radius, radius, 0.0, -radius - 3.0, radius + 3.0], np.float32)
    off = rng.choice(choices, (b, c, h, w, m, l, p, 2)).astype(np.float32)
    xla, pallas = _jax_pair(value, off, wgt, radius)
    ours = _port(value, off, wgt, radius)
    np.testing.assert_allclose(ours, xla, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


def test_plain_matches_pallas_bf16_value(rng):
    """The kernel's staging: the value in bf16, offsets and weights in f32.
    The Pallas kernel with kernel_dtype=bf16 rounds the value as the port's
    caller does, so only the f32 summation order differs."""
    radius = 4
    value, off, wgt = windowed_inputs(rng, 1, 3, 6, 20, 8, 16, 4, 3, -5.0, 5.0)
    _, pallas = _jax_pair(value, off, wgt, radius, kernel_dtype=jnp.bfloat16)
    value_bf16 = torch.from_numpy(value).to(torch.bfloat16)
    ours = ms_deform_attn_windowed(value_bf16, torch.from_numpy(off), torch.from_numpy(wgt), radius,
                                   flatten=False).numpy()
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


def test_dispatch_on_cpu_runs_the_plain_version(rng):
    value, off, wgt = windowed_inputs(rng, 1, 2, 4, 6, 2, 4, 2, 2, -2.0, 2.0)
    tv, to, tw = torch.from_numpy(value), torch.from_numpy(off), torch.from_numpy(wgt)
    out = windowed_attention(tv, to, tw, radius=2)
    assert out.shape == (1, 2 * 4 * 6, 8) and out.dtype == torch.float32
    torch.testing.assert_close(out, ms_deform_attn_windowed(tv, to, tw, 2), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        windowed_attention(tv, to, tw, radius=2, row_halo=True)


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    """No fallback: the kernel wrapper takes CUDA tensors or raises."""
    value, off, wgt = windowed_inputs(rng, 1, 2, 4, 6, 2, 4, 2, 2, -2.0, 2.0)
    before = msda_windowed_fwd.launches
    with pytest.raises(ValueError, match="CUDA device only"):
        msda_windowed_fwd(torch.from_numpy(value).to(torch.bfloat16), torch.from_numpy(off),
                          torch.from_numpy(wgt), 2)
    assert msda_windowed_fwd.launches == before


@pytest.mark.parametrize("w,m,d,p,radius,align,vec,tile", [
    (180, 8, 16, 4, 4, 16, 8, (4, 16)),  # the flagship: 16-byte taps, 2 threads per (query, head)
    (180, 2, 16, 4, 0, 16, 8, (4, 16)),
    (180, 8, 16, 4, 7, 16, 8, (4, 16)),
    (180, 8, 16, 4, 8, 16, 8, (8, 16)),  # from R=8 on: twice the queries
    (180, 8, 16, 4, 16, 16, 8, (8, 16)),  # B4's radius
    (101, 2, 5, 4, 4, 16, 1, (1, 16)),  # 2-byte taps, 5 threads per (query, head)
    (21, 1, 1024, 4, 4, 16, 8, (1, 1)),  # M*D = 1024: 128 threads for one query
    (21, 1, 1024, 4, 4, 8, 4, (1, 1)),  # 8-byte taps: 256 threads for one query
    (21, 1, 1022, 4, 4, 16, 2, (1, 1)),  # 4-byte taps: 511 threads for one query
    (21, 8, 128, 4, 4, 16, 8, (1, 8)),
    (21, 3, 6, 4, 2, 16, 2, (2, 16)),
    (180, 8, 16, 4, 4, 4, 2, (1, 16)),  # a value pointer aligned to 4 bytes only
    (180, 8, 16, 3, 4, 16, 8, (4, 16)),  # P = 3: the generic sample loop
])
def test_fwd_plan_admits_the_kernels_shapes(w, m, d, p, radius, align, vec, tile):
    """B1's plan: the widest tap load that D and the value's alignment
    allow, 16 queries wide, about 128 threads a block (256 from R=8 on), and
    never more threads than the kernel's block of that load width takes."""
    plan = _fwd_plan(w, m, d, p, radius, value_align=align)
    assert (plan.vec, (plan.tile_y, plan.tile_x)) == (vec, tile)
    assert plan.threads == tile[0] * tile[1] * (d // vec) <= (1024 if vec <= 2 else 256)


@pytest.mark.parametrize("kwargs,match", [
    (dict(w=180, m=8, d=129, p=4, radius=4), "M\\*D"),  # M*D > 1024
    (dict(w=180, m=1, d=1025, p=4, radius=4), "M\\*D"),
    (dict(w=180, m=0, d=16, p=4, radius=4), "M\\*D"),
    (dict(w=180, m=8, d=0, p=4, radius=4), "M\\*D"),
    (dict(w=180, m=8, d=16, p=4, radius=-1), "non-negative"),
    (dict(w=180, m=8, d=16, p=4, radius=1.5), "non-negative"),
    (dict(w=180, m=8, d=16, p=-1, radius=4), "non-negative"),
    (dict(w=2**20, m=8, d=128, p=4, radius=16), "32-bit"),
    (dict(w=180, m=8, d=128, p=4, radius=100_000), "32-bit"),
    (dict(w=2**14, m=8, d=128, p=4, radius=63), "32-bit"),  # B2's byte offsets: 2 (R+1)(W+1)K just reaches 2^31
])
def test_fwd_plan_raises_on_what_the_kernel_cannot_take(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _fwd_plan(**kwargs)
