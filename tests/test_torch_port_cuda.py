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
from mvdetr_tpu_torch.models.world_feat.modules import _resize_bilinear
from mvdetr_tpu_torch.ops import lane_broadcast as lb
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


@pytest.mark.parametrize("radius,m,d,integer,c,hw", [
    (4, 8, 16, False, 3, (9, 21)), (4, 8, 16, True, 3, (9, 21)), (0, 2, 16, False, 3, (9, 21)),
    (1, 2, 16, False, 3, (9, 21)), (8, 2, 16, False, 3, (9, 21)), (12, 2, 16, False, 3, (9, 21)),
    (16, 2, 16, False, 3, (9, 21)), (2, 3, 5, False, 3, (9, 21)), (4, 2, 8, False, 3, (9, 21)),
    (4, 2, 32, False, 3, (9, 21)), (4, 2, 5, False, 3, (9, 21)), (4, 2, 16, False, 3, (37, 101)),
    (4, 2, 16, False, 5, (9, 21)), (3, 2, 16, True, 2, (37, 101)), (4, 1, 1024, False, 3, (9, 21)),
    (2, 1, 6, False, 3, (9, 21)),
])
def test_kernel_matches_plain_on_card(radius, m, d, integer, c, hw, rng, cuda_device):
    """B1 vs the plain version fed the same bf16 value (L=3 levels, ``c``
    cameras): only the f32 summation order may differ, outputs of order 1 ->
    atol 2e-5. Two launches are bitwise equal, and so are launches of the C
    entry point under other tiles that fit; it refuses a plan it cannot take.
    D=5 and D=6 take 2- and 4-byte taps, D=8 one 16-byte tap per head,
    M*D=1024 one query per block; 37x101 is no multiple of the tile."""
    from mvdetr_tpu_torch.ops.msda_windowed import _fwd_plan, _value_align, load_library

    l, p = 3, 4
    h, wd = hw
    value, off, wgt = windowed_inputs(rng, 2, l, h, wd, m, d, p, c, -radius - 1.5, radius + 1.5)
    if integer:
        off = (radial_offset_bias(m, l, p, max_radius=radius).reshape(m, l, p, 2)
               + rng.integers(-2, 3, off.shape)).astype(np.float32)
    v = torch.from_numpy(value).to(cuda_device, torch.bfloat16)
    o = torch.from_numpy(off).to(cuda_device)
    w = torch.from_numpy(wgt).to(cuda_device)
    before = msda_windowed_fwd.launches
    out = windowed_attention(v, o, w, radius=radius, flatten=False)
    again = msda_windowed_fwd(v, o, w, radius)
    torch.cuda.synchronize()
    assert msda_windowed_fwd.launches == before + 2
    ref = ms_deform_attn_windowed(v, o, w, radius, flatten=False)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
    assert torch.equal(out, again)
    vec = _fwd_plan(wd, m, d, p, radius, value_align=_value_align(v)).vec

    def launch(tile_y, tile_x):
        res = torch.empty_like(out)
        err = load_library().msda_windowed_fwd_launch(
            v.data_ptr(), o.data_ptr(), w.data_ptr(), res.data_ptr(), 2, c, l, h, wd, m, d, p, radius, vec, tile_y,
            tile_x, torch.cuda.current_stream().cuda_stream)
        return err, res

    for tile in ((8, 16), (3, 5), (1, 1), (2, 7)):
        if tile[0] * tile[1] * (d // vec) > (1024 if vec <= 2 else 256):
            assert launch(*tile)[0] == 1  # cudaErrorInvalidValue: more threads than the block takes
            continue
        err, res = launch(*tile)
        assert err == 0
        torch.cuda.synchronize()
        assert torch.equal(res, out), tile
    assert launch(0, 16)[0] == 1


@pytest.mark.parametrize("radius,m,d,integer,c,hw,p", [
    (4, 8, 16, False, 3, (9, 21), 4), (4, 8, 16, True, 3, (9, 21), 4), (0, 2, 16, False, 3, (9, 21), 4),
    (1, 2, 16, False, 3, (9, 21), 4), (8, 2, 16, False, 3, (9, 21), 4), (12, 2, 16, False, 3, (9, 21), 4),
    (16, 2, 16, False, 3, (9, 21), 4), (2, 3, 21, False, 3, (9, 21), 4), (4, 2, 8, False, 3, (9, 21), 4),
    (4, 2, 32, False, 3, (9, 21), 4), (4, 2, 5, False, 3, (9, 21), 4), (4, 2, 16, False, 3, (37, 101), 4),
    (4, 2, 16, False, 5, (9, 21), 4), (3, 2, 16, True, 2, (37, 101), 4), (4, 2, 16, False, 3, (9, 21), 3),
    (2, 2, 5, True, 2, (9, 21), 3), (4, 1, 1024, False, 3, (9, 21), 4),
])
def test_bwd_kernel_matches_plain_on_card(radius, m, d, integer, c, hw, p, rng, cuda_device):
    """B2 vs the plain backward on the same bf16 value (L=3 levels, ``c``
    cameras, ``p`` points): f32 sums of a few hundred terms in another order,
    cotangents of order 1-10 -> atol 1e-4 of max(1, max|ref|). Exactly
    integer offsets give exactly zero offset cotangents; two launches are
    bitwise equal, and so are the value side and the query side launched
    alone. D=21 and D=32 take two channel chunks on the value side, D=5 and
    D=8 part of one; on the query side D=16 and D=32 combine 2 and 4 lanes by
    shuffles, D=5, D=21 (1-channel loads) and M=1, D=1024 (128 lanes over
    four warps) through shared memory, and P=3 takes the generic sample loop;
    37x101 is no multiple of either tile."""
    l = 3
    h, wd = hw
    value, off, wgt = windowed_inputs(rng, 2, l, h, wd, m, d, p, c, -radius - 1.5, radius + 1.5)
    if integer:
        off = (radial_offset_bias(m, l, p, max_radius=radius).reshape(m, l, p, 2)
               + rng.integers(-2, 3, off.shape)).astype(np.float32)
    v = torch.from_numpy(value).to(cuda_device, torch.bfloat16)
    o = torch.from_numpy(off).to(cuda_device)
    w = torch.from_numpy(wgt).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((2, c, h, wd, m * d)).astype(np.float32)).to(cuda_device)
    ours = msda_windowed_bwd(v, o, w, g, radius)
    again = msda_windowed_bwd(v, o, w, g, radius)
    value_side = msda_windowed_bwd(v, o, w, g, radius, side="value")[0]
    query_side = msda_windowed_bwd(v, o, w, g, radius, side="query")[1:]
    ref = ms_deform_attn_windowed_bwd(v, o, w, g, radius)
    torch.cuda.synchronize()
    for a, b, r in zip(ours, again, ref):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, r, rtol=0, atol=1e-4 * max(1.0, float(r.abs().max())))
    assert torch.equal(value_side, ours[0])
    assert torch.equal(query_side[0], ours[1]) and torch.equal(query_side[1], ours[2])
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


@pytest.mark.parametrize("variant", ["matmul", "repeat", "jnp_repeat", "bcast3d", "r_matmul", "r_reshape_sum"])
def test_lane_kernel_matches_plain_on_card(variant, rng, cuda_device):
    """B5: each variant's kernel against its plain version at the flagship
    widths (LM=56, D=16), a ragged T=40 and 81 repetitions; the sums differ
    only by FMA contraction, the shuffle tree and the tf32 hi/lo split ->
    atol 1e-5 of max|ref|."""
    t = 40
    x = torch.from_numpy(rng.standard_normal((t, lb.LM)).astype(np.float32)).to(cuda_device)
    v = torch.from_numpy(rng.standard_normal((t, lb.LM * lb.D)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    dlk = torch.from_numpy(rng.standard_normal((t, lb.LM * lb.D)).astype(np.float32)).to(cuda_device)
    if variant in lb.BROADCAST_VARIANTS:
        before = lb.lane_broadcast.launches[variant]
        out, ref = lb.lane_broadcast(x, v, variant), lb.lane_broadcast_plain(x, v, variant)
        assert lb.lane_broadcast.launches[variant] == before + 1
    else:
        before = lb.lane_reduce.launches[variant]
        out, ref = lb.lane_reduce(dlk, variant), lb.lane_reduce_plain(dlk, variant)
        assert lb.lane_reduce.launches[variant] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resize_backward_repeats_bitwise_on_card(dtype, rng, cuda_device):
    """The BEV upsample's resize at the flagship shape (narrow channels):
    its backward is two matrix products, with no atomics."""
    x = torch.from_numpy(rng.standard_normal((2, 16, 60, 180)).astype(np.float32)).to(cuda_device, dtype)
    g = torch.from_numpy(rng.standard_normal((2, 16, 120, 360)).astype(np.float32)).to(cuda_device, dtype)
    grads = []
    for _ in range(2):
        xt = x.clone().requires_grad_()
        _resize_bilinear(xt, (120, 360)).backward(g)
        grads.append(xt.grad)
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])


def test_two_train_steps_repeat_bitwise_on_card(cuda_device):
    """Two bf16 train steps with dropout, from the same initial state and
    generator seed, with PyTorch's default algorithms: bitwise-equal losses,
    gradients and parameters."""
    rig = make_synthetic_rig(**RIG)
    batch = synthetic_train_batch(rig, 2, world_reduce=2, img_reduce=12, seed=0)
    runs = []
    for _ in range(2):
        model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, compute_dtype=torch.bfloat16, device="cuda",
                                seed=0)
        state = create_train_state(model, lr=5e-4, total_steps=10)
        _, aux = train_step(state, batch, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        runs.append((float(aux["loss"]),
                     {n: (p.detach().clone(), p.grad.clone()) for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for n, (p, g) in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n][0]) and torch.equal(g, runs[1][1][n][1]), n
