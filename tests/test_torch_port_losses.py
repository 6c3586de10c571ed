"""Losses and training targets of the port against the JAX package, on the
same numpy inputs.

Tolerances: the losses are f32 sums of a few thousand terms, taken in
another order on each side -> rtol 1e-5. The targets are numpy copies of the
same arithmetic and must agree exactly (heatmaps to 1e-7, the native splat
extension may evaluate the Gaussian in another precision)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvdetr_tpu import losses as jax_losses
from mvdetr_tpu.data.targets import build_targets as jax_build_targets
from mvdetr_tpu_torch import losses
from mvdetr_tpu_torch.data import build_targets

RTOL = 1e-5


@pytest.fixture(scope="module")
def maps():
    r = np.random.default_rng(11)
    logits = r.normal(0, 3, (2, 9, 13, 1)).astype(np.float32)
    target = np.clip(r.uniform(-0.5, 1.0, (2, 9, 13, 1)), 0, None).astype(np.float32)
    target[0, 3, 4, 0] = target[1, 7, 2, 0] = target[1, 0, 12, 0] = 1.0  # exact positives
    return logits, target


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_clamped_sigmoid_matches_jax(maps):
    x = np.concatenate([maps[0].ravel(), [-30.0, 30.0, 0.0]]).astype(np.float32)
    np.testing.assert_allclose(losses.clamped_sigmoid(_t(x)).numpy(),
                               np.asarray(jax_losses.clamped_sigmoid(jnp.asarray(x))), rtol=RTOL)


@pytest.mark.parametrize("case", ["positives", "no_positive", "masked"])
def test_focal_loss_matches_jax(maps, case):
    """Positives are cells where the target is exactly 1.0: a target of
    0.9999999 counts as a negative on both sides."""
    logits, target = maps
    target = target.copy()
    target[0, 0, 0, 0] = np.float32(0.9999999)
    mask = None
    if case == "no_positive":
        target = np.minimum(target, 0.9)
    elif case == "masked":
        mask = (np.random.default_rng(1).uniform(size=target.shape) > 0.3).astype(np.float32)
    ref = jax_losses.focal_loss(jnp.asarray(logits), jnp.asarray(target),
                                None if mask is None else jnp.asarray(mask))
    ours = losses.focal_loss(_t(logits), _t(target), None if mask is None else _t(mask))
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)


def test_reg_l1_and_gather_match_jax():
    r = np.random.default_rng(5)
    out = r.normal(size=(2, 6, 7, 2)).astype(np.float32)
    idx = r.integers(0, 42, (2, 10))
    mask = r.uniform(size=(2, 10)) > 0.4
    target = r.normal(size=(2, 10, 2)).astype(np.float32)
    np.testing.assert_array_equal(losses.gather_at_indices(_t(out), _t(idx)).numpy(),
                                  np.asarray(jax_losses.gather_at_indices(jnp.asarray(out), jnp.asarray(idx))))
    ref = jax_losses.reg_l1_loss(jnp.asarray(out), jnp.asarray(mask), jnp.asarray(idx), jnp.asarray(target))
    ours = losses.reg_l1_loss(_t(out), _t(mask), _t(idx), _t(target))
    np.testing.assert_allclose(float(ours), float(ref), rtol=RTOL)
    # an empty mask divides by the 1e-4 floor: zero loss on both sides
    empty = np.zeros_like(mask)
    assert float(losses.reg_l1_loss(_t(out), _t(empty), _t(idx), _t(target))) == 0.0
    assert float(jax_losses.reg_l1_loss(jnp.asarray(out), jnp.asarray(empty), jnp.asarray(idx),
                                        jnp.asarray(target))) == 0.0


def test_gaussian_mse_matches_jax(maps):
    logits, target = maps
    np.testing.assert_allclose(float(losses.gaussian_mse_loss(_t(logits), _t(target))),
                               float(jax_losses.gaussian_mse_loss(jnp.asarray(logits), jnp.asarray(target))),
                               rtol=RTOL)


@pytest.mark.parametrize("with_wh", [True, False])
def test_build_targets_matches_jax(with_wh):
    """People partly outside the map, more of them than top_k, overlapping
    splats (max-composited)."""
    r = np.random.default_rng(3)
    n = 14
    xs = r.uniform(-20, 260, n)
    ys = r.uniform(-10, 130, n)
    xs[1], ys[1] = xs[0] + 3, ys[0] + 2  # overlapping Gaussians
    ws, hs = (r.uniform(5, 30, n), r.uniform(20, 90, n)) if with_wh else (None, None)
    pids = r.integers(0, 1000, n)
    kw = dict(reduce=4, top_k=12, kernel_size=10.0)
    ours = build_targets((30, 60), xs, ys, ws, hs, pids, **kw)
    ref = jax_build_targets((30, 60), xs, ys, ws, hs, pids, **kw)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        if k == "heatmap":
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-7)
        else:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert 0 < ours["reg_mask"].sum() < 12 and (ours["heatmap"] == 1.0).sum() >= 1
