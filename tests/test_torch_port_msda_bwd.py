"""Backward of windowed deformable attention (TPU kernel B2): the port's
plain backward against the Pallas backward in interpret mode and against
``jax.vjp`` of the XLA op, on the same numpy inputs. The CUDA kernel is held
against the plain backward on the card by ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py``. Also B4: the large-radius (x-grid) Pallas forward.

The port follows the Pallas kernel's gradient convention: its hat
derivative is -sign(t) for |t| < 1 and 0 otherwise, with t computed in f32,
so an exactly integer offset gets a zero cotangent (and an offset within
f32 resolution of an integer, as the radial init's ~1e-16 components, keeps
one slope only). Autodiff of the XLA op gives a central difference at
integers instead; at ordinary non-integer offsets the three agree.

Tolerances: f32 inputs, f32 sums of up to a few hundred terms in another
order on each side, cotangents of order 1-10 -> atol 5e-5 (observed ~1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu.ops.msda_windowed import ms_deform_attn_windowed as jax_windowed
from mvdetr_tpu.ops.pallas.msda_kernel import msda_windowed_pallas
from mvdetr_tpu.ops.pallas.msda_kernel_bwd import msda_windowed_pallas_bwd
from mvdetr_tpu_torch.models.deformable import radial_offset_bias
from mvdetr_tpu_torch.ops.msda_windowed import (
    ms_deform_attn_windowed,
    ms_deform_attn_windowed_bwd,
    msda_windowed_bwd,
    windowed_attention,
)
from _torch_port import windowed_inputs

ATOL = 5e-5


def _cotangent(rng, off):
    b, c, h, w, m = off.shape[:5]
    d = 16
    return rng.standard_normal((b, c, h, w, m * d)).astype(np.float32)


def _pallas_bwd(value, off, wgt, g, radius, kernel_dtype=jnp.float32):
    out = msda_windowed_pallas_bwd(jnp.asarray(value), jnp.asarray(off), jnp.asarray(wgt), jnp.asarray(g), radius,
                                   kernel_dtype=kernel_dtype, interpret=True)
    return [np.asarray(x) for x in out]


def _xla_vjp(value, off, wgt, g, radius):
    def f(v, o, w):
        return jax_windowed(v, o, w, radius, flatten=False)

    _, vjp = jax.vjp(f, jnp.asarray(value), jnp.asarray(off), jnp.asarray(wgt))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_bwd(value, off, wgt, g, radius):
    out = ms_deform_attn_windowed_bwd(torch.from_numpy(value), torch.from_numpy(off), torch.from_numpy(wgt),
                                      torch.from_numpy(g), radius)
    return [x.numpy() for x in out]


def _assert_all_close(ours, ref, atol=ATOL):
    for name, a, b in zip(("g_value", "g_offsets", "g_weights"), ours, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


def _integer_offsets(rng, b, c, h, w, m, l, p, radius):
    bias = radial_offset_bias(m, l, p, max_radius=radius).reshape(m, l, p, 2)
    return (bias + rng.integers(-2, 3, (b, c, h, w, m, l, p, 2))).astype(np.float32)


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_plain_bwd_matches_pallas_random_offsets_past_the_clamp(radius, rng):
    """Offsets up to 1.5 cells beyond +-R bind the clamp (their cotangent is
    zero); W=20 and H=7 divide by neither 8 nor the TPU row tile."""
    value, off, wgt = windowed_inputs(rng, 2, 3, 7, 20, 8, 16, 4, 3, -radius - 1.5, radius + 1.5)
    g = _cotangent(rng, off)
    ours = _port_bwd(value, off, wgt, g, radius)
    _assert_all_close(ours, _pallas_bwd(value, off, wgt, g, radius))
    assert (ours[1][np.abs(off) > radius] == 0).all()


@pytest.mark.parametrize("radius", [1, 4])
def test_plain_bwd_matches_pallas_integer_offsets(radius, rng):
    """The radial init shifted by random integers: at R=4 (8 heads, 7
    levels, 4 points) 81% of its components are exact integers and the rest
    are cos(pi/2)-sized (~1e-16), where the TPU kernel's f32 hat slopes keep
    one tap only; at R=1 it is in quarter cells. Exact integers get exactly
    zero offset cotangents on both sides."""
    b, l, h, w, m, p, c = 1, 7, 6, 12, 8, 4, 2
    value, _, wgt = windowed_inputs(rng, b, l, h, w, m, 16, p, c, 0, 1)
    off = _integer_offsets(rng, b, c, h, w, m, l, p, radius)
    g = _cotangent(rng, off)
    ours = _port_bwd(value, off, wgt, g, radius)
    pallas = _pallas_bwd(value, off, wgt, g, radius)
    _assert_all_close(ours, pallas)
    integer = off == np.round(off)
    assert integer.mean() > 0.3
    assert (ours[1][integer] == 0).all() and (pallas[1][integer] == 0).all()


@pytest.mark.parametrize("radius", [1, 4])
def test_plain_bwd_matches_pallas_offsets_on_the_clamp(radius, rng):
    """Offsets of exactly +-R (and 0, and far beyond), with the other
    component random: the outermost ring's corner at R+1 has weight 0 and
    takes no value cotangent."""
    b, l, h, w, m, p, c = 1, 2, 6, 10, 8, 3, 2
    value, off, wgt = windowed_inputs(rng, b, l, h, w, m, 16, p, c, -radius + 0.2, radius - 0.2)
    choices = np.array([-radius, radius, 0.0, -radius - 3.0, radius + 3.0], np.float32)
    off[..., 0] = rng.choice(choices, off.shape[:-1])
    g = _cotangent(rng, off)
    _assert_all_close(_port_bwd(value, off, wgt, g, radius), _pallas_bwd(value, off, wgt, g, radius))


@pytest.mark.parametrize("radius", [2, 4])
def test_plain_bwd_matches_xla_vjp_at_non_integer_offsets(radius, rng):
    value, off, wgt = windowed_inputs(rng, 1, 3, 7, 11, 8, 16, 4, 3, -radius - 1.0, radius + 1.0)
    assert (off != np.round(off)).all()
    g = _cotangent(rng, off)
    _assert_all_close(_port_bwd(value, off, wgt, g, radius), _xla_vjp(value, off, wgt, g, radius))


@pytest.mark.parametrize("radius,m,d,c,h,w", [(0, 2, 16, 3, 5, 9), (2, 2, 5, 3, 6, 11), (2, 2, 8, 3, 6, 11),
                                               (1, 1, 32, 3, 6, 11), (2, 2, 16, 5, 6, 11), (3, 2, 16, 2, 9, 37)])
def test_plain_bwd_matches_pallas_at_the_card_cases(radius, m, d, c, h, w, rng):
    """The plain backward, which the card's B2 kernel is held against, agrees
    with the Pallas backward at the edges the kernel's cases cover: R=0,
    D=5, 8 and 32 (part of one 16-channel chunk, two chunks), more or fewer
    cameras than levels (C=5 and C=2 over L=3), and a 9x37 grid."""
    l, p = 3, 4
    value, off, wgt = windowed_inputs(rng, 1, l, h, w, m, d, p, c, -radius - 1.5, radius + 1.5)
    g = rng.standard_normal((1, c, h, w, m * d)).astype(np.float32)
    _assert_all_close(_port_bwd(value, off, wgt, g, radius), _pallas_bwd(value, off, wgt, g, radius))


def test_plain_bwd_against_pallas_at_its_bf16_kernel_dtype():
    """At its default ``kernel_dtype=bf16`` the Pallas backward rounds g and
    the products v*g to bf16 on the query side (`msda_kernel_bwd.py:77,117`);
    the port keeps f32 products (ROADMAP C.3), as Pallas at f32 does. On a
    bf16 value (the inputs of that record, numpy seed 0) the query-side
    cotangents then differ by ~1.4e-3 (g_offsets) and ~2.2e-3 (g_weights) of
    their scale -> 5e-3 of scale; g_value is f32 products on both sides ->
    ATOL."""
    rng = np.random.default_rng(0)
    value, off, wgt = windowed_inputs(rng, 1, 3, 6, 20, 8, 16, 4, 3, -5.0, 5.0)
    value = torch.from_numpy(value).to(torch.bfloat16).float().numpy()
    g = _cotangent(rng, off)
    ours = _port_bwd(value, off, wgt, g, 4)
    pallas = _pallas_bwd(value, off, wgt, g, 4, kernel_dtype=jnp.bfloat16)
    np.testing.assert_allclose(ours[0], pallas[0], rtol=0, atol=ATOL)
    for a, b in zip(ours[1:], pallas[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-3 * float(np.abs(b).max()))


def test_xla_and_pallas_disagree_at_integer_offsets(rng):
    """The JAX package disagrees with itself at integer offsets (ROADMAP B2):
    the XLA vjp's central difference is far from the Pallas kernel's zero.
    The value and weight cotangents agree, and the port follows Pallas."""
    b, l, h, w, m, p, c, radius = 1, 7, 6, 12, 8, 4, 2, 4
    value, _, wgt = windowed_inputs(rng, b, l, h, w, m, 16, p, c, 0, 1)
    off = _integer_offsets(rng, b, c, h, w, m, l, p, radius)
    g = _cotangent(rng, off)
    xla = _xla_vjp(value, off, wgt, g, radius)
    pallas = _pallas_bwd(value, off, wgt, g, radius)
    tie = (np.abs(off) < radius) & (off == np.round(off))  # both neighbours of the tie in the window
    assert np.abs(xla[1][tie]).max() > 0.5 and (pallas[1][tie] == 0).all()
    np.testing.assert_allclose(xla[0], pallas[0], atol=ATOL)
    np.testing.assert_allclose(xla[2], pallas[2], atol=ATOL)


def test_cpu_autograd_goes_through_the_plain_backward(rng):
    """``windowed_attention`` on CPU tensors differentiates through the
    hand-written backward, not autograd of the plain forward: at integer
    offsets the offset gradient is exactly 0, as on the card."""
    b, l, h, w, m, p, c, radius = 1, 3, 5, 7, 2, 4, 3, 2
    value, _, wgt = windowed_inputs(rng, b, l, h, w, m, 16, p, c, 0, 1)
    off = rng.integers(-radius - 1, radius + 2, (b, c, h, w, m, l, p, 2)).astype(np.float32)
    g = rng.standard_normal((b, c * h * w, m * 16)).astype(np.float32)
    tv, to, tw = (torch.from_numpy(x).requires_grad_() for x in (value, off, wgt))
    windowed_attention(tv, to, tw, radius).backward(torch.from_numpy(g))
    ref = _port_bwd(value, off, wgt, g.reshape(b, c, h, w, m * 16), radius)
    for got, want in zip((tv.grad, to.grad, tw.grad), ref):
        np.testing.assert_array_equal(got.numpy(), want)
    assert (to.grad == 0).all()
    # autograd of the 4-tap plain forward would have given one-sided differences
    tv2, to2, tw2 = (torch.from_numpy(x).requires_grad_() for x in (value, off, wgt))
    ms_deform_attn_windowed(tv2, to2, tw2, radius).backward(torch.from_numpy(g))
    assert (to2.grad != 0).any()


def test_bwd_kernel_wrapper_refuses_cpu_tensors(rng):
    """No fallback: the B2 wrapper takes CUDA tensors or raises."""
    value, off, wgt = windowed_inputs(rng, 1, 2, 4, 6, 2, 4, 2, 2, -2.0, 2.0)
    g = torch.zeros(1, 2, 4, 6, 8)
    before = msda_windowed_bwd.launches
    with pytest.raises(ValueError, match="CUDA device only"):
        msda_windowed_bwd(torch.from_numpy(value).to(torch.bfloat16), torch.from_numpy(off),
                          torch.from_numpy(wgt), g, 2)
    assert msda_windowed_bwd.launches == before


def test_bwd_kernel_wrapper_refuses_an_unknown_side(rng):
    """``side`` picks the value side, the query side or both; anything else
    raises before a launch."""
    value, off, wgt = windowed_inputs(rng, 1, 2, 4, 6, 2, 4, 2, 2, -2.0, 2.0)
    before = msda_windowed_bwd.launches
    with pytest.raises(ValueError, match="side must be one of"):
        msda_windowed_bwd(torch.from_numpy(value).to(torch.bfloat16), torch.from_numpy(off),
                          torch.from_numpy(wgt), torch.zeros(1, 2, 4, 6, 8), 2, side="values")
    assert msda_windowed_bwd.launches == before


# ------------------------------------------------------------------ B4
@pytest.mark.parametrize("radius", [12, 16])
def test_plain_forward_matches_pallas_xgrid_variant(radius, rng, monkeypatch):
    """B4: the large-radius Pallas forward (x-shift on a grid axis), forced
    with MVDETR_MSDA_XGRID=1 as `test_pallas_xgrid_variant_matches_xla`
    does. B1 takes any radius, so its plain version must agree; the card
    check at R=12 and R=16 is in chip_smoke.py."""
    monkeypatch.setenv("MVDETR_MSDA_XGRID", "1")
    b, l, h, w, m, d, p, c = 1, 2, 24, 16, 8, 16, 3, 2
    value, off, wgt = windowed_inputs(rng, b, l, h, w, m, d, p, c, -radius - 1, radius + 1)
    ref = np.asarray(msda_windowed_pallas(jnp.asarray(value), jnp.asarray(off), jnp.asarray(wgt), radius,
                                          kernel_dtype=jnp.float32, interpret=True))
    ours = ms_deform_attn_windowed(torch.from_numpy(value), torch.from_numpy(off), torch.from_numpy(wgt), radius,
                                   flatten=False).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-5)


def test_plain_bwd_matches_xla_vjp_at_radius_12(rng):
    """The JAX package has no Pallas backward above radius 8; B2 takes any
    radius, and its plain version agrees with the XLA vjp at R=12."""
    radius = 12
    value, off, wgt = windowed_inputs(rng, 1, 2, 20, 18, 2, 16, 3, 2, -radius - 2.0, radius + 2.0)
    g = _cotangent(rng, off)
    _assert_all_close(_port_bwd(value, off, wgt, g, radius), _xla_vjp(value, off, wgt, g, radius))
