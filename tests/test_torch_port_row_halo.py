"""Row-halo windowed attention (TPU kernels B1 and B2 in ``row_halo`` mode)
and the BEV-row-sharded composition, on the CPU:

- the port's plain ``row_halo`` forward and backward against JAX's XLA op
  (``ms_deform_attn_windowed(row_halo=True)``, the backward through
  ``jax.vjp``) and the Pallas kernels in interpret mode
  (``msda_windowed_pallas(row_halo=True)``,
  ``msda_windowed_pallas_bwd_prepped(row_halo=True)``);
- zero halo rows give the zero-padded call's values, forward and backward;
- the port's one-process composition of N shards
  (``ops/msda_sharded.py::compose_bev_shards``, halos cut from the full map)
  against JAX's ``bev_row_sharded_windowed_attention`` on a 4-shard ``bev``
  axis of the conftest's 8 CPU devices, and against the port's unsharded
  attention: the forward bitwise equal, as ``tests/test_parallel.py``
  asserts for JAX; the offsets' and weights' gradients bitwise equal; the
  value's gradient bitwise equal on rows that one shard's queries alone
  reach, within f32 rounding where two shards' halos add up.

The CUDA kernels' halo mode is held against these plain versions, and
against the unsharded kernels, by ``chip_smoke.py`` on the card.

Tolerance: f32 inputs and f32 sums of up to a few hundred terms in another
order (XLA's (2R+1)^2 shifted windows, the Pallas selection matmuls) -> atol
2e-5, as ``tests/test_torch_port_msda.py``. Offsets are uniform, so none is
an integer, where XLA's vjp takes a central difference and the port the
Pallas kernel's convention.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu.ops.msda_sharded import bev_row_sharded_windowed_attention as jax_sharded
from mvdetr_tpu.ops.msda_windowed import ms_deform_attn_windowed as jax_windowed
from mvdetr_tpu.ops.pallas.msda_kernel import msda_windowed_pallas, prep_inputs
from mvdetr_tpu.ops.pallas.msda_kernel_bwd import msda_windowed_pallas_bwd_prepped
from mvdetr_tpu.parallel import make_mesh as jax_make_mesh
from mvdetr_tpu_torch.ops.msda_sharded import compose_bev_shards
from mvdetr_tpu_torch.ops.msda_windowed import (
    ms_deform_attn_windowed,
    ms_deform_attn_windowed_bwd,
    windowed_attention,
)
from _torch_port import windowed_inputs

ATOL = 2e-5
NAMES = ("g_value", "g_offsets", "g_weights")


def _halo_inputs(rng, b, l, h, w, m, d, p, c, radius):
    """A value of ``h + 2 * radius`` rows for ``h`` query rows; offsets up to
    1.5 cells past the clamp, so the halo rows' taps and the clamp both occur."""
    _, off, wgt = windowed_inputs(rng, b, l, h, w, m, d, p, c, -radius - 1.5, radius + 1.5)
    value = rng.standard_normal((b, l, h + 2 * radius, w, m, d)).astype(np.float32)
    return value, off, wgt


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("radius", [1, 3, 4])
def test_plain_row_halo_forward_matches_jax_xla_and_pallas(radius, rng):
    value, off, wgt = _halo_inputs(rng, 2, 3, 7, 20, 8, 16, 4, 3, radius)  # the Pallas kernels take M*D = 128
    ours = ms_deform_attn_windowed(*_t(value, off, wgt), radius, flatten=False, row_halo=True).numpy()
    args = (jnp.asarray(value), jnp.asarray(off), jnp.asarray(wgt))
    xla = np.asarray(jax_windowed(*args, radius, flatten=False, row_halo=True))
    pallas = np.asarray(msda_windowed_pallas(*args, radius, kernel_dtype=jnp.float32, row_halo=True,
                                             interpret=True))
    assert ours.shape == xla.shape == pallas.shape == (2, 3, 7, 20, 128)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=ATOL)


@pytest.mark.parametrize("radius", [1, 4])
def test_plain_row_halo_backward_matches_pallas_and_xla_vjp(radius, rng):
    value, off, wgt = _halo_inputs(rng, 2, 3, 7, 20, 8, 16, 4, 3, radius)
    g = rng.standard_normal((2, 3, 7, 20, 128)).astype(np.float32)
    ours = [x.numpy() for x in ms_deform_attn_windowed_bwd(*_t(value, off, wgt, g), radius, row_halo=True)]

    args = (jnp.asarray(value), jnp.asarray(off), jnp.asarray(wgt))
    vp, ox, oy, wg = prep_inputs(*args, radius, jnp.float32, row_halo=True)
    pallas = msda_windowed_pallas_bwd_prepped(vp, ox, oy, wg, jnp.asarray(g), m=8, d=16, p=4, w=20, radius=radius,
                                              row_halo=True, interpret=True)
    _, vjp = jax.vjp(lambda v, o, w: jax_windowed(v, o, w, radius, flatten=False, row_halo=True), *args)
    xla = vjp(jnp.asarray(g))
    assert ours[0].shape == (2, 3, 7 + 2 * radius, 20, 8, 16)
    for ref in (pallas, xla):
        for name, a, b in zip(NAMES, ours, ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=ATOL, err_msg=name)


def test_zero_halo_rows_give_the_zero_padded_values(rng):
    """A halo of zero rows is the zero padding: the same output values, and
    the same cotangents (``g_value`` on the inner rows; the halo rows'
    gradient is what the zero-padded call drops)."""
    r = 3
    value, off, wgt = windowed_inputs(rng, 1, 3, 9, 13, 2, 8, 4, 2, -r - 1.5, r + 1.5)
    g = torch.from_numpy(rng.standard_normal((1, 2, 9, 13, 16)).astype(np.float32))
    tv, to, tw = _t(value, off, wgt)
    halo = torch.nn.functional.pad(tv, (0, 0, 0, 0, 0, 0, r, r))
    assert torch.equal(ms_deform_attn_windowed(halo, to, tw, r, row_halo=True), ms_deform_attn_windowed(tv, to, tw, r))
    padded = ms_deform_attn_windowed_bwd(tv, to, tw, g, r)
    with_halo = ms_deform_attn_windowed_bwd(halo, to, tw, g, r, row_halo=True)
    assert torch.equal(with_halo[0][:, :, r:r + 9], padded[0])
    assert torch.equal(with_halo[1], padded[1]) and torch.equal(with_halo[2], padded[2])


B, L, H, W, M, D, P, C, R, SHARDS = 2, 3, 16, 20, 2, 4, 3, 3, 3, 4


def _sharded_inputs(rng):
    value = rng.standard_normal((B, L, H, W, M, D)).astype(np.float32)
    _, off, wgt = windowed_inputs(rng, B, L, H, W, M, D, P, C, -R - 1.5, R + 1.5)
    return value, off, wgt


def test_composed_shards_match_jax_sharded_and_the_unsharded_forward(rng):
    """4 BEV shards of 4 rows at R=3 (2 data x 4 bev on the 8 CPU devices)."""
    value, off, wgt = _sharded_inputs(rng)
    mesh = jax_make_mesh(num_bev_shards=SHARDS)
    assert dict(mesh.shape) == {"data": 2, "view": 1, "bev": 4}
    ref = np.asarray(jax_sharded(jnp.asarray(value), jnp.asarray(off), jnp.asarray(wgt), mesh, radius=R, axis="bev"))
    tv, to, tw = _t(value, off, wgt)
    ours = compose_bev_shards(tv, to, tw, SHARDS, R)
    assert torch.equal(ours, windowed_attention(tv, to, tw, R, flatten=False))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)


def _reached_by_one_shard(h, n, r):
    """The value rows whose taps all come from queries of their own shard:
    a query at row q taps rows q + floor(oy) and q + floor(oy) + 1, so row y
    is reached from query rows [y - r - 1, y + r]."""
    y, rows = np.arange(h), h // n
    lo, hi = np.clip(y - r - 1, 0, h - 1) // rows, np.clip(y + r, 0, h - 1) // rows
    return (lo == y // rows) & (hi == y // rows)


@pytest.mark.parametrize("shards", [2, SHARDS])
def test_composed_shards_gradients_against_the_unsharded_attention(shards, rng):
    value, off, wgt = _sharded_inputs(rng)
    g = torch.from_numpy(rng.standard_normal((B, C, H, W, M * D)).astype(np.float32))
    grads = []
    for fn in (lambda v, o, w: compose_bev_shards(v, o, w, shards, R),
               lambda v, o, w: windowed_attention(v, o, w, R, flatten=False)):
        inputs = [t.requires_grad_() for t in _t(value, off, wgt)]
        fn(*inputs).backward(g)
        grads.append([t.grad for t in inputs])
    (sv, so, sw), (uv, uo, uw) = grads
    assert torch.equal(so, uo) and torch.equal(sw, uw)
    inner = torch.from_numpy(_reached_by_one_shard(H, shards, R))
    assert int(inner.sum()) == {2: 9, 4: 1}[shards]
    assert torch.equal(sv[:, :, inner], uv[:, :, inner])
    np.testing.assert_allclose(sv.numpy(), uv.numpy(), rtol=0, atol=1e-6)
