"""Tests that need the card. They import nothing of JAX, so the card's machine
runs them as they are (``python -m pytest tests/test_torch_port_cuda.py -q``);
elsewhere every test skips. ``chip_smoke.py`` repeats the kernel checks at the
flagship shapes."""

import numpy as np
import pytest
import torch

from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.deformable import radial_offset_bias
from mvdetr_tpu_torch.ops.msda_windowed import (
    ms_deform_attn_windowed,
    ms_deform_attn_windowed_bwd,
    msda_windowed_bwd,
    msda_windowed_fwd,
    windowed_attention,
)
from mvdetr_tpu_torch.ops.sampling import bilinear_scatter_matmul
from mvdetr_tpu_torch.ops.warp import warp_bwd
from mvdetr_tpu_torch.train import create_train_state, eval_step, train_step
from _torch_port import cuda_device, synthetic_train_batch, windowed_inputs  # noqa: F401

pytestmark = pytest.mark.cuda

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))


@pytest.mark.parametrize("radius,m,d", [(4, 8, 16), (1, 2, 16), (8, 2, 16), (2, 3, 5)])
def test_kernel_matches_plain_on_card(radius, m, d, rng, cuda_device):
    """CUDA kernel vs the plain version fed the same bf16 value: only the f32
    summation order differs, outputs of order 1 -> atol 2e-5."""
    value, off, wgt = windowed_inputs(rng, 2, 3, 9, 21, m, d, 4, 3, -radius - 1.5, radius + 1.5)
    v = torch.from_numpy(value).to(cuda_device, torch.bfloat16)
    o = torch.from_numpy(off).to(cuda_device)
    w = torch.from_numpy(wgt).to(cuda_device)
    before = msda_windowed_fwd.launches
    out = windowed_attention(v, o, w, radius=radius, flatten=False)
    torch.cuda.synchronize()
    assert msda_windowed_fwd.launches == before + 1
    ref = ms_deform_attn_windowed(v, o, w, radius, flatten=False)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("radius,m,d,integer", [(4, 8, 16, False), (4, 8, 16, True), (1, 2, 16, False),
                                                (8, 2, 16, False), (12, 2, 16, False), (2, 3, 21, False)])
def test_bwd_kernel_matches_plain_on_card(radius, m, d, integer, rng, cuda_device):
    """B2 vs the plain backward on the same bf16 value: f32 sums of a few
    hundred terms in another order, cotangents of order 1-10 -> atol 1e-4.
    Exactly integer offsets give exactly zero offset cotangents; two launches are
    bitwise equal. D=21 takes two channel chunks on the value side."""
    l, p = 3, 4
    value, off, wgt = windowed_inputs(rng, 2, l, 9, 21, m, d, p, l, -radius - 1.5, radius + 1.5)
    if integer:
        off = (radial_offset_bias(m, l, p, max_radius=radius).reshape(m, l, p, 2)
               + rng.integers(-2, 3, off.shape)).astype(np.float32)
    v = torch.from_numpy(value).to(cuda_device, torch.bfloat16)
    o = torch.from_numpy(off).to(cuda_device)
    w = torch.from_numpy(wgt).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((2, l, 9, 21, m * d)).astype(np.float32)).to(cuda_device)
    ours = msda_windowed_bwd(v, o, w, g, radius)
    again = msda_windowed_bwd(v, o, w, g, radius)
    ref = ms_deform_attn_windowed_bwd(v, o, w, g, radius)
    torch.cuda.synchronize()
    for a, b, r in zip(ours, again, ref):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, r, rtol=0, atol=1e-4)
    if integer:  # the radial init's cos(pi/2) ~ 1e-16 components are not exact integers
        exact = o == torch.round(o)
        assert exact.float().mean() > 0.5 and int((ours[1][exact] != 0).sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_bwd_kernel_matches_plain_on_card(dtype, rng, cuda_device):
    """B3 vs the plain one-hot contraction with the same roundings: f32 sums
    in another order; in bf16 the final rounding may land one bf16 step
    apart (up to 2^-7 relative) -> rtol 1.6e-2. Coordinates span past the
    map on every side; two launches are bitwise equal."""
    b, q, c, h, w = 3, 700, 40, 11, 17
    sx = torch.from_numpy(rng.uniform(-2.0, w + 1.0, (b, q)).astype(np.float32)).to(cuda_device)
    sy = torch.from_numpy(rng.uniform(-2.0, h + 1.0, (b, q)).astype(np.float32)).to(cuda_device)
    sx[0, :20] = torch.floor(sx[0, :20])  # integer coordinates: one-hot rows of weight exactly 1
    g = torch.from_numpy(rng.standard_normal((b, q, c)).astype(np.float32)).to(cuda_device, dtype)
    before = warp_bwd.launches
    ours = warp_bwd(g, sx, sy, h, w)
    again = warp_bwd(g, sx, sy, h, w)
    assert warp_bwd.launches == before + 2
    ref = bilinear_scatter_matmul(g, sx, sy, h, w)
    torch.cuda.synchronize()
    assert ours.dtype == dtype and torch.equal(ours, again)
    rtol = 1.6e-2 if dtype == torch.bfloat16 else 0
    torch.testing.assert_close(ours.float(), ref.float(), rtol=rtol, atol=2e-5)


def test_backward_through_autograd_launches_the_kernel(rng, cuda_device):
    """A CUDA tensor's backward goes through B2, and cotangents come back in
    the inputs' dtypes."""
    value, off, wgt = windowed_inputs(rng, 1, 2, 4, 6, 8, 16, 2, 2, -2.0, 2.0)
    v = torch.from_numpy(value).to(cuda_device).requires_grad_()
    o = torch.from_numpy(off).to(cuda_device).requires_grad_()
    w = torch.from_numpy(wgt).to(cuda_device, torch.bfloat16).requires_grad_()
    before = msda_windowed_bwd.launches
    windowed_attention(v, o, w, 2).square().sum().backward()
    assert msda_windowed_bwd.launches == before + 1
    assert (v.grad.dtype, o.grad.dtype, w.grad.dtype) == (torch.float32, torch.float32, torch.bfloat16)


def test_eval_step_on_card_launches_the_kernel_per_layer(cuda_device):
    rig = make_synthetic_rig(**RIG)
    model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, compute_dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    batch = {"imgs": rng.integers(0, 256, (2, 3, 64, 106, 3), dtype=np.uint8),
             "affine_mats": np.tile(np.eye(3, dtype=np.float32), (2, 3, 1, 1))}
    before = msda_windowed_fwd.launches
    aux, xys, keep = eval_step(model, batch, world_reduce=2, num_candidates=64)
    assert msda_windowed_fwd.launches == before + 3
    assert xys.shape == (2, 64, 3) and keep.shape == (2, 64)
    assert torch.isfinite(xys).all() and 0.0 <= float(aux["offset_clip_fraction"]) <= 1.0


def test_train_step_on_card_launches_each_kernel(cuda_device):
    """One bf16 train step with dropout: B1 and B2 once per encoder layer, B3
    once for all B*N views; the loss is finite and the parameters move."""
    rig = make_synthetic_rig(**RIG)
    model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, compute_dtype=torch.bfloat16, device="cuda")
    state = create_train_state(model, lr=5e-4, total_steps=10)
    batch = synthetic_train_batch(rig, 2, world_reduce=2, img_reduce=12, seed=0)
    before = [p.detach().clone() for p in model.parameters()]
    counts = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
    state, aux = train_step(state, batch, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    after = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
    assert tuple(a - b for a, b in zip(after, counts)) == (3, 3, 1)
    assert np.isfinite(float(aux["loss"])) and state.step == 1
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
