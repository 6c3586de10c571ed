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
from mvdetr_tpu_torch.ops import warp as warp_ops
from mvdetr_tpu_torch.ops.warp import warp_bwd
from mvdetr_tpu_torch.train import create_train_state, eval_step, train_step
from _torch_port import cuda_device, synthetic_train_batch, windowed_inputs  # noqa: F401
from chip_smoke import (
    RECIPE_GATHER_ATTENTION, WARP_STRESS_NAMES, bwd_case, fwd_case, gather_card_vs_cpu, gather_inputs, gather_run,
    gather_vs_windowed, gather_warp_inputs, shadow_warp_inputs, warp_case, warp_stress_cases,
)

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


@pytest.mark.parametrize("name", WARP_STRESS_NAMES)
def test_warp_bwd_stress_cases_on_card(name, cuda_device):
    """B3 at ``chip_smoke.warp_stress_cases`` through ``chip_smoke.warp_case``:
    within rtol 2^-6 (bf16; 0 in f32) + 1e-5 of the plain version, two
    launches bitwise equal, bitwise equal to the plain version where every
    partial sum is exact (one cell of 3000 entries per tap), NaN coordinates
    giving the bits of far-out ones; every tap outside gives zeros."""
    case = warp_stress_cases(np.random.default_rng(0))[name]
    before = warp_bwd.launches
    warp_case(name, case["g"], case["sx"], case["sy"], case["h"], case["w"], exact=case["exact"],
              ref_xy=case["ref_xy"])
    assert warp_bwd.launches > before
    if name == "all-outside":
        assert not warp_bwd(case["g"], case["sx"], case["sy"], case["h"], case["w"]).any()


@pytest.mark.parametrize("integer", [False, True])
def test_kernels_over_the_shadow_stack_on_card(integer, cuda_device):
    """B1 and B2 through ``chip_smoke.fwd_case``/``bwd_case`` over the 56
    pseudo-levels of one point of a 7-camera, 8-point shadow stack on a 9x21
    grid (the generic point loop): within their bounds of the plain versions,
    two launches bitwise equal; offsets at integers, drawn from the radial
    init of 7 cameras x 8 points, get exactly zero cotangents."""
    shape = dict(b=2, l=56, c=7, h=9, w=21, m=8, d=16, p=1, radius=4, init=(7, 8))
    rng = np.random.default_rng(1)
    before = (msda_windowed_fwd.launches, msda_windowed_bwd.launches)
    fwd_case("shadow-card-test", **shape, integer=integer, rng=rng, timed=False)
    bwd_case("shadow-card-test", **shape, integer=integer, rng=rng, timed=False)
    assert (msda_windowed_fwd.launches, msda_windowed_bwd.launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_warp_bwd_at_shadow_coordinates_on_card(dtype, cuda_device):
    """B3 at the Wildtrack-width rig's 8-point shadow coordinates (g [14,
    86400, 128] onto 60x180, ``chip_smoke.shadow_warp_inputs``): within rtol
    2^-6 (bf16; 0 in f32) + 1e-5 of the plain version, bitwise repeat."""
    c = shadow_warp_inputs(np.random.default_rng(2), dtype=dtype)
    before = warp_bwd.launches
    warp_case(f"shadow-{dtype}", c["g"], c["sx"], c["sy"], c["h"], c["w"])
    assert warp_bwd.launches == before + 2


def test_warped_model_steps_launch_each_kernel_on_card(cuda_device):
    """The n_points-8 model in warped mode: a request launches B1 3 times and
    neither backward; a bf16 train step B1 and B2 3 times each and B3 4
    times (the camera warp and each layer's shadow warp), with a finite loss;
    two steps from the same state and generator repeat bitwise."""
    rig = make_synthetic_rig(**RIG)
    batch = synthetic_train_batch(rig, 2, world_reduce=2, img_reduce=12, seed=0)
    runs = []
    for _ in range(2):
        model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, n_points=8, compute_dtype=torch.bfloat16,
                                device="cuda", seed=0)
        assert model.world_feat.mode == "warped"
        counts = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
        eval_step(model, batch, world_reduce=2, num_candidates=64)
        after = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
        assert tuple(a - b for a, b in zip(after, counts)) == (3, 0, 0)
        state = create_train_state(model, lr=5e-4, total_steps=10)
        state, aux = train_step(state, batch, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        final = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
        assert tuple(a - b for a, b in zip(final, after)) == (3, 3, 4)
        assert np.isfinite(float(aux["loss"]))
        runs.append((float(aux["loss"]), {n: p.detach().clone() for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_backward_repeats_bitwise_on_card(dtype, cuda_device):
    """Gather attention at the recipe's shape: two forwards and backwards
    from the same inputs give the same bits, the value's gradient from one
    B3 launch each (no float atomic on the path)."""
    rng = np.random.default_rng(4)
    value, off, wgt, ref = gather_inputs(rng, **RECIPE_GATHER_ATTENTION, reach=6.0)
    g = torch.from_numpy(rng.standard_normal((1, 4 * 15 * 30, 128), dtype=np.float32)).cuda()
    before = warp_bwd.launches
    runs = [gather_run(value.to(dtype), off, wgt, ref, g.to(dtype), RECIPE_GATHER_ATTENTION) for _ in range(2)]
    assert warp_bwd.launches == before + 2
    for a, b in zip(*runs):
        assert a.dtype in (dtype, torch.float32) and bool(torch.isfinite(a).all()) and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_warp_bwd_at_gather_coordinates_on_card(dtype, cuda_device):
    """B3 at the coordinates of gather attention's value gradient at the
    recipe's shape (g [32, 7200, 16] onto 15x30; the radial init in bf16,
    random offsets in f32): within rtol 2^-6 (bf16; 0 in f32) + 1e-5, of
    scale, of the plain version, bitwise repeat."""
    c = gather_warp_inputs(np.random.default_rng(5), RECIPE_GATHER_ATTENTION, dtype,
                           reach=None if dtype == torch.bfloat16 else 6.0)
    before = warp_bwd.launches
    warp_case(f"gather-{dtype}", c["g"], c["sx"], c["sy"], c["h"], c["w"], scaled=True)
    assert warp_bwd.launches == before + 2


def test_gather_matches_cpu_and_windowed_on_card(cuda_device):
    """Gather attention in f32 at the recipe's shape: the card's output and
    three gradients against the CPU's (1e-5 of scale), and against B1/B2
    where no clamp binds (2e-5 of scale)."""
    rng = np.random.default_rng(6)
    gather_card_vs_cpu("recipe", RECIPE_GATHER_ATTENTION, rng)  # each raises past its bound
    gather_vs_windowed(rng, "recipe", RECIPE_GATHER_ATTENTION)


@pytest.mark.parametrize("kw", [dict(attn_mode="gather"), dict(world_feat_arch="aio")], ids=["gather", "aio"])
def test_gather_and_aio_models_launch_b3_per_layer_on_card(kw, cuda_device):
    """A request launches no kernel; a bf16 train step B3 4 times (the camera
    warp and each encoder layer's value gradient) and neither B1 nor B2;
    two steps from the same state and generator repeat bitwise."""
    rig = make_synthetic_rig(**RIG)
    batch = synthetic_train_batch(rig, 2, world_reduce=2, img_reduce=12, seed=0)
    runs = []
    for _ in range(2):
        model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, compute_dtype=torch.bfloat16, device="cuda",
                                seed=0, **kw)
        assert model.world_feat.mode == "gather"
        counts = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
        aux, _, _ = eval_step(model, batch, world_reduce=2, num_candidates=64)
        assert "offset_clip_fraction" not in aux
        after = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
        assert after == counts
        state = create_train_state(model, lr=5e-4, total_steps=10)
        state, aux = train_step(state, batch, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        final = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
        assert tuple(a - b for a, b in zip(final, after)) == (0, 0, 4)
        assert np.isfinite(float(aux["loss"]))
        runs.append((float(aux["loss"]), {n: p.detach().clone() for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n


def test_warp_bwd_scratch_on_card(rng, cuda_device):
    """The wrapper's scratch: 18-bit keys at the flagship's 14 x 90 x 160
    cells and CUB's temporary bytes; after a launch the keys are sorted and
    end at most at the sentinel, and the output is the wrapper's."""
    lib = warp_ops.load_library()
    s = warp_ops.alloc_scratch(lib, 14, 300, 90, 160, cuda_device)
    assert s.end_bit == 18 and s.keys.shape == (2, 4 * 14 * 300) and s.start.shape == (14 * 90 * 160 + 1,)
    assert s.temp.numel() > 0
    b, q, c, h, w = 2, 900, 24, 11, 17
    sx = torch.from_numpy(rng.uniform(-2.0, w + 1.0, (b, q)).astype(np.float32)).to(cuda_device)
    sy = torch.from_numpy(rng.uniform(-2.0, h + 1.0, (b, q)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((b, q, c)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    out = torch.empty((b, h, w, c), dtype=g.dtype, device=cuda_device)
    scratch = warp_ops.alloc_scratch(lib, b, q, h, w, cuda_device)
    warp_ops.launch(lib, g, sx, sy, out, scratch)
    torch.cuda.synchronize()
    assert torch.equal(out, warp_bwd(g, sx, sy, h, w))
    keys = scratch.keys[1]
    assert bool((keys[1:] >= keys[:-1]).all()) and int(keys[-1]) <= b * h * w
    assert int(scratch.start[0]) == 0 and int(scratch.start[-1]) == int((keys < b * h * w).sum())


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


def test_prefetch_uploads_ahead_and_reraises_on_card(cuda_device):
    """``prefetch_to_device`` on the card: pinned, ``non_blocking`` copies on
    a side stream give the same values as a plain upload, ``frame`` stays
    numpy, and an error of the host iterator re-raises on the consumer's
    side after the batches before it."""
    from mvdetr_tpu_torch.data import prefetch_to_device

    rng = np.random.default_rng(0)
    items = [{"imgs": rng.integers(0, 256, (2, 3, 64, 96, 3), dtype=np.uint8), "frame": np.array([i, i + 1]),
              "world_gt": {"heatmap": rng.standard_normal((2, 8, 8, 1)).astype(np.float32)}} for i in range(5)]

    def host():
        yield from items
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for item in prefetch_to_device(host(), cuda_device, size=2):
            # consume on the default stream, as a step does
            got.append({"imgs": item["imgs"].float().sum().item(), "frame": item["frame"],
                        "heatmap": item["world_gt"]["heatmap"].cpu().numpy()})
    assert len(got) == len(items)
    for g, item in zip(got, items):
        assert g["imgs"] == float(item["imgs"].astype(np.float64).sum()) and isinstance(g["frame"], np.ndarray)
        np.testing.assert_array_equal(g["heatmap"], item["world_gt"]["heatmap"])


def test_trainer_epoch_and_test_on_card(cuda_device, tmp_path):
    """One epoch and a CLEAR test of the port's Trainer on the card from a
    synthetic scene, checkpointed and restored bitwise."""
    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
    from mvdetr_tpu_torch.train import Trainer, restore_checkpoint, save_checkpoint

    rig = make_synthetic_rig(**RIG)
    scene = SyntheticScene(rig, num_frame=6, num_person=4, seed=1)
    kw = dict(world_reduce=2, img_reduce=12, top_k=8, world_kernel_size=4, img_kernel_size=4)
    model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, device=cuda_device, seed=0)
    state = create_train_state(model, lr=1e-3, total_steps=4)
    trainer = Trainer(state, FrameDataset(scene, train=True, augmentation=True, **kw),
                      FrameDataset(scene, train=False, **kw), cls_thres=0.3, num_workers=2, logger=lambda *a: None)
    trainer.check_determinism(batch_size=2)
    loss = trainer.train_epoch(1, batch_size=2)
    assert np.isfinite(loss) and state.step == 2
    result = trainer.test(batch_size=2, res_fpath=str(tmp_path / "test.txt"))
    assert np.isfinite(result[0])
    save_checkpoint(str(tmp_path / "ckpt"), state)
    restored = restore_checkpoint(str(tmp_path / "ckpt"), create_train_state(
        MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, device=cuda_device, seed=5), lr=1e-3, total_steps=4))
    for key, value in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[key], value), key


def test_deform_conv_backward_launches_b3_once_on_card(cuda_device):
    """``deform_conv2d_grouped`` on the card against the CPU in f32 (3
    cameras' maps, offsets past the border among them): the forward and all
    four gradients; each backward launches B3 once, for the input's gradient
    over all 9 taps, and two backwards are bitwise equal."""
    from mvdetr_tpu_torch.ops.deform_conv import deform_conv2d_grouped

    rng = np.random.default_rng(4)
    arrays = (rng.standard_normal((3, 2, 12, 20, 16)), rng.normal(0, 3.0, (3, 2, 12, 20, 9, 2)),
              rng.standard_normal((3, 3, 3, 16, 24)) * 0.2, rng.standard_normal((3, 24)))
    g = torch.from_numpy(rng.standard_normal((3, 2, 12, 20, 24)).astype(np.float32))
    results = {}
    for dev in ("cpu", "cuda", "cuda"):
        ts = [torch.from_numpy(a.astype(np.float32)).to(dev).requires_grad_() for a in arrays]
        before = warp_bwd.launches
        out = deform_conv2d_grouped(*ts)
        out.backward(g.to(dev))
        torch.cuda.synchronize()
        assert warp_bwd.launches == before + (dev == "cuda")
        results.setdefault(dev, []).append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    for a, b in zip(*results["cuda"]):
        assert torch.equal(a, b)
    for a, b in zip(results["cpu"][0], results["cuda"][0]):
        torch.testing.assert_close(b, a, rtol=0, atol=2e-4 * max(1.0, float(a.abs().max())))


@pytest.mark.parametrize("config", ["conv", "trans", "deform_conv", "vgg11", "remat"])
def test_variant_models_launch_their_kernels_on_card(config, cuda_device):
    """Each ported variant in bf16: a request launches B1/B2/B3 as
    ``chip_smoke.FULL_WIDTH`` says (3/0/0 with the windowed fusion, none
    otherwise), a train step too (conv and trans 0/0/1, deform_conv 0/0/2,
    vgg11 and remat 3/3/1); two steps from the same state and generator
    repeat bitwise."""
    from chip_smoke import FULL_WIDTH

    kw, _, per_request, per_step = FULL_WIDTH[config]
    rig = make_synthetic_rig(**RIG)
    batch = synthetic_train_batch(rig, 2, world_reduce=2, img_reduce=12, seed=0)
    runs = []
    for _ in range(2):
        model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, compute_dtype=torch.bfloat16, device="cuda",
                                seed=0, **kw)
        counts = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
        eval_step(model, batch, world_reduce=2, num_candidates=64)
        after = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
        assert tuple(a - b for a, b in zip(after, counts)) == per_request
        state = create_train_state(model, lr=5e-4, total_steps=10)
        _, aux = train_step(state, batch, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        final = (msda_windowed_fwd.launches, msda_windowed_bwd.launches, warp_bwd.launches)
        assert tuple(a - b for a, b in zip(final, after)) == per_step
        assert np.isfinite(float(aux["loss"]))
        runs.append((float(aux["loss"]), {n: p.detach().clone() for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n


@pytest.mark.parametrize("radius,m,d,hw", [(4, 8, 16, (9, 21)), (1, 2, 16, (37, 101)), (3, 2, 5, (9, 21)),
                                           (8, 2, 8, (12, 30))])
def test_row_halo_kernels_on_card(radius, m, d, hw, rng, cuda_device):
    """B1 and B2 in row_halo mode (the value H + 2R rows) against their plain
    versions on the same bf16 value: atol 2e-5 and 1e-4 of scale, as the
    zero-padded cases; two launches bitwise equal. Zero halo rows give the
    zero-padded launches' bits (B2's g_value on the inner rows), and three
    BEV shards composed (``compose_bev_shards``) give the unsharded output's."""
    from mvdetr_tpu_torch.ops.msda_sharded import compose_bev_shards

    h, wd = hw
    value, off, wgt = windowed_inputs(rng, 2, 3, h + 2 * radius, wd, m, d, 4, 3, -radius - 1.5, radius + 1.5)
    v = torch.from_numpy(value).to(cuda_device, torch.bfloat16)
    o = torch.from_numpy(off[:, :, :h]).contiguous().to(cuda_device)
    w = torch.from_numpy(wgt[:, :, :h]).contiguous().to(cuda_device)
    g = torch.randn((2, 3, h, wd, m * d), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    out = msda_windowed_fwd(v, o, w, radius, row_halo=True)
    torch.testing.assert_close(out, ms_deform_attn_windowed(v, o, w, radius, flatten=False, row_halo=True),
                               rtol=0, atol=2e-5)
    assert torch.equal(out, msda_windowed_fwd(v, o, w, radius, row_halo=True))
    grads = msda_windowed_bwd(v, o, w, g, radius, row_halo=True)
    assert grads[0].shape == v.shape
    for got, ref, again in zip(grads, ms_deform_attn_windowed_bwd(v, o, w, g, radius, row_halo=True),
                               msda_windowed_bwd(v, o, w, g, radius, row_halo=True)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * max(1.0, float(ref.abs().max())))
        assert torch.equal(got, again)

    inner = v[:, :, radius:radius + h].contiguous()
    zero = torch.nn.functional.pad(inner, (0, 0, 0, 0, 0, 0, radius, radius))
    assert torch.equal(msda_windowed_fwd(zero, o, w, radius, row_halo=True), msda_windowed_fwd(inner, o, w, radius))
    padded, halo = msda_windowed_bwd(inner, o, w, g, radius), msda_windowed_bwd(zero, o, w, g, radius, row_halo=True)
    assert torch.equal(halo[0][:, :, radius:radius + h], padded[0])
    assert torch.equal(halo[1], padded[1]) and torch.equal(halo[2], padded[2])
    if h % 3 == 0 and h // 3 >= radius:
        assert torch.equal(compose_bev_shards(inner, o, w, 3, radius), msda_windowed_fwd(inner, o, w, radius))
