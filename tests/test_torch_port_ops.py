"""Geometry copies, warp, decode and NMS: the port against the JAX package on
the same numpy inputs. Decode, top-K and NMS take identical input arrays on
both sides and must agree exactly; float paths state their tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.ops import decode as jax_decode
from mvdetr_tpu.ops import nms as jax_nms
from mvdetr_tpu.ops import warp as jax_warp
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.ops import decode, nms, warp


def test_geometry_copy_matches_jax_package():
    """The port's numpy copy of the rig gives the same matrices, bit for bit."""
    kw = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96), indexing="ij",
              worldcoord_unit=0.01, origin_offset=(-150.0, -450.0))
    ours, ref = make_synthetic_rig(**kw), jax_make_rig(**kw)
    np.testing.assert_array_equal(ours.proj_mats(world_reduce=2), ref.proj_mats(world_reduce=2))
    np.testing.assert_array_equal(ours.reference_points(2, 2, 8), ref.reference_points(2, 2, 8))
    assert ours.shadow_reach_cells(2, 2) == ref.shadow_reach_cells(2, 2)
    assert ours.Rworld_shape(2) == ref.Rworld_shape(2)


def _homographies(rng, n):
    """Near-identity homographies with perspective terms, scaled so part of
    each destination grid falls outside the source support."""
    m = np.tile(np.eye(3), (n, 1, 1)) + rng.normal(0, 0.05, (n, 3, 3))
    m[:, 2, :2] = rng.normal(0, 0.01, (n, 2))
    m[:, :2, 2] = rng.uniform(-6, 6, (n, 2))
    m[:, :2, :2] *= rng.uniform(0.6, 1.6, (n, 1, 1))
    return m.astype(np.float32)


def test_invert_3x3_matches_jax(rng):
    """Same closed form; XLA may contract products into FMAs -> rtol 1e-6."""
    m = _homographies(rng, 16)
    np.testing.assert_allclose(warp.invert_3x3(torch.from_numpy(m)).numpy(),
                               np.asarray(jax_warp.invert_3x3(jnp.asarray(m))), rtol=1e-6, atol=1e-7)


def test_warp_coords_match_jax_including_the_z_clamp(rng):
    """Random homographies (rtol 1e-5: a 3-term f32 dot and a division), and
    one whose inverse sends the column x=2 to z=0 exactly: the eps clamp
    must give the same huge coordinates on both sides."""
    m = _homographies(rng, 4)
    ours = warp.warp_coords(torch.from_numpy(m), (9, 13))
    ref = jax_warp._warp_coords(jnp.asarray(m), (9, 13))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)

    horizon = np.array([[[1.0, 0, 0], [0, 1.0, 0], [0.5, 0, -1.0]]], np.float32)  # its own inverse
    sx, sy = warp.warp_coords(torch.from_numpy(horizon), (3, 5))
    rx, ry = jax_warp._warp_coords(jnp.asarray(horizon), (3, 5))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(sy.numpy(), np.asarray(ry))
    assert np.abs(sx.numpy()).max() >= 1e8  # the clamped column


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_perspective_warp_matches_jax(dtype, atol, rng):
    """Destination cells partly outside the source. f32: the same 4-tap sum
    in another order (atol 1e-5). bf16: the weights are rounded to bf16 on
    both sides, and the frameworks round the 4-tap contraction differently by
    up to an ulp of values below 4 (atol 3e-2)."""
    feats = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    m = _homographies(rng, 2)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    ref = np.asarray(jax_warp.perspective_warp(jnp.asarray(feats, jd), jnp.asarray(m), (10, 14)), np.float32)
    ours = warp.perspective_warp(torch.from_numpy(feats).to(td), torch.from_numpy(m), (10, 14))
    assert ours.dtype == td and ours.shape == (2, 10, 14, 16)
    assert (ref == 0).all(axis=-1).any(), "some destination cells should fall outside the source"
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=atol)


def test_heatmap_peaks_and_decode_match_jax_exactly(rng):
    """Integer-valued scores make plateaus (ties) in the 3x3 max."""
    score = rng.integers(0, 5, (2, 9, 11, 1)).astype(np.float32) / 4
    offset = rng.uniform(-0.5, 0.5, (2, 9, 11, 2)).astype(np.float32)
    np.testing.assert_array_equal(decode.heatmap_peaks(torch.from_numpy(score)).numpy(),
                                  np.asarray(jax_decode.heatmap_peaks(jnp.asarray(score))))
    for off in (offset, None):
        ours = decode.mvdet_decode(torch.from_numpy(score), None if off is None else torch.from_numpy(off), 4)
        ref = jax_decode.mvdet_decode(jnp.asarray(score), None if off is None else jnp.asarray(off), 4)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_top_k_matches_lax_top_k_with_ties(rng):
    x = rng.integers(0, 6, (3, 40)).astype(np.float32)
    vals, idx = decode.top_k(torch.from_numpy(x), 17)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 17)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))


def _jax_keep(points, scores, dist, valid=None):
    fn = lambda p, s, v: jax_nms.distance_nms(p, s, dist, v)  # noqa: E731
    v = np.ones(scores.shape, bool) if valid is None else valid
    return np.asarray(jax.vmap(fn)(jnp.asarray(points), jnp.asarray(scores), jnp.asarray(v)))


def test_nms_ties_at_the_radius_and_invalid_candidates():
    """(0,0)-(20,0) and (0,0)-(12,16) lie exactly 20 apart: dropped. (40,0)
    is 20 from the dropped (20,0) only: kept. The invalid best-scoring
    candidate next to (0,0) suppresses nothing and is not kept. Equal scores
    are walked in descending index order, as the JAX argsort does."""
    pts = np.array([[[0, 0], [20, 0], [12, 16], [40, 0], [1, 1], [70, 0], [70, 20.5]]], np.float32)
    sc = np.array([[0.9, 0.8, 0.8, 0.7, 0.99, 0.5, 0.5]], np.float32)
    valid = np.array([[True, True, True, True, False, True, True]])
    ours = nms.distance_nms(torch.from_numpy(pts), torch.from_numpy(sc), 20.0, torch.from_numpy(valid))
    ref = _jax_keep(pts, sc, 20.0, valid)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ref[0], [True, False, False, True, False, True, True])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_matches_jax_on_random_and_chained_candidates(seed):
    """Random clustered candidates with tied scores, plus a chain spaced 15
    apart with falling scores, where each keep decision hangs on the one
    before it (the longest dependency the fixed-point loop can meet)."""
    r = np.random.default_rng(seed)
    k = 96
    pts = np.round(r.uniform(0, 120, (2, k, 2)) / 4) * 4
    pts[1, :40, 0] = np.arange(40) * 15.0
    pts[1, :40, 1] = 0.0
    sc = np.round(r.uniform(0, 1, (2, k)), 1).astype(np.float32)
    sc[1, :40] = np.linspace(1.0, 0.6, 40)
    valid = r.uniform(size=(2, k)) > 0.1
    pts = pts.astype(np.float32)
    for v in (None, valid):
        ours = nms.distance_nms(torch.from_numpy(pts), torch.from_numpy(sc), 20.0,
                                None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(ours.numpy(), _jax_keep(pts, sc, 20.0, v))
