"""The BEV upsample's bilinear resize (``models/world_feat/modules.py::
_resize_bilinear``, the separable product ``Ry @ x @ Rx^T``) against
``jax.image.resize(..., "bilinear")``, the JAX package's resize
(`mvdetr_tpu/models/world_feat/modules.py:36-38`), in value and gradient.

Shapes: the flagship's 60x180 -> 120x360 with narrow channels, a ratio that
is not 2 (7x11 -> 13x21, as odd world shapes give), and a downsample (JAX's
default antialias widens the kernel there). f32 on both sides: each output is
a sum of at most a few products in another order, so atol = 1e-6 of
max(1, max|ref|). In bf16 the two round at other places (ROADMAP C.2), and
the bound is one bf16 ulp of the output scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvdetr_tpu_torch.models.world_feat.modules import DeformTransWorldFeat, _resize_bilinear, resize_matrix

SHAPES = [((60, 180), (120, 360)), ((7, 11), (13, 21)), ((13, 21), (7, 11))]
ATOL = 1e-6


def _jax_resize(x_nchw, out_hw):
    b, c = x_nchw.shape[:2]
    y = jax.image.resize(jnp.transpose(x_nchw, (0, 2, 3, 1)), (b, *out_hw, c), method="bilinear")
    return jnp.transpose(y, (0, 3, 1, 2))


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=0, atol=ATOL * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("in_hw,out_hw", SHAPES)
def test_resize_matches_jax_image_resize(in_hw, out_hw):
    x = np.random.default_rng(0).standard_normal((2, 3, *in_hw)).astype(np.float32)
    _close(_resize_bilinear(torch.from_numpy(x), out_hw), _jax_resize(jnp.asarray(x), out_hw))


@pytest.mark.parametrize("in_hw,out_hw", SHAPES)
def test_resize_matches_jax_image_resize_bf16(in_hw, out_hw):
    """The port multiplies in f32 and rounds once; ``jax.image.resize`` also
    rounds its weights and its first contraction to bf16. About a third of
    the outputs differ, each by at most one bf16 ulp of the output scale."""
    x = np.random.default_rng(0).standard_normal((2, 3, *in_hw)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ours = _resize_bilinear(xt, out_hw)
    ref = np.asarray(_jax_resize(jnp.asarray(xt.float().numpy(), jnp.bfloat16), out_hw).astype(jnp.float32))
    assert ours.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)  # bf16 keeps 8 significant bits
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0, atol=ulp)


@pytest.mark.parametrize("in_hw,out_hw", SHAPES)
def test_resize_gradient_matches_jax_vjp(in_hw, out_hw):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, *in_hw)).astype(np.float32)
    g = rng.standard_normal((2, 3, *out_hw)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: _jax_resize(a, out_hw), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    _resize_bilinear(xt, out_hw).backward(torch.from_numpy(g))
    _close(xt.grad, vjp(jnp.asarray(g))[0])


def test_resize_matrices_stay_out_of_the_state_dict():
    """The upsample holds its matrices as non-persistent buffers: the
    checkpoint names stay the reference's, and the buffers follow the module."""
    wf = DeformTransWorldFeat(2, (14, 22), base_dim=16, hidden_dim=16, nhead=2, dim_feedforward=16,
                              attn_mode="windowed")
    resize = wf.upsample[0]
    assert not any(k.startswith("upsample.0") for k in wf.state_dict())
    np.testing.assert_array_equal(resize.ry.numpy(), resize_matrix(7, 14))
    np.testing.assert_array_equal(resize.rx_t.numpy(), resize_matrix(11, 22).T)
    np.testing.assert_array_equal(resize_matrix(5, 5), np.eye(5, dtype=np.float32))
