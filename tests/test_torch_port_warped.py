"""Shadow-warped deformable attention (``n_points=8``, ``warped`` mode) against
the JAX package: the shadow warp, the attention forward and backward, the
attention module and the shadow transformer, on the same numpy inputs.

The reference maps are the synthetic rig's 8-point shadow maps (both
packages' ``CameraRig.reference_points``, equal to the bit) or, where said,
a smooth random map. The JAX side runs through XLA (``use_pallas=False``,
as on any backend but the TPU): it splits more than 8 pseudo-levels into
chunks of at most 8 and adds their outputs, the port makes one call over all
``L*P``, so the two agree to f32 rounding, not bitwise.

Gradients are compared at offsets away from integers and from +-R: at an
integer offset the port takes the TPU kernel's convention (a zero
cotangent) and JAX's XLA vjp a central difference (``test_torch_port_msda_bwd.py``).
At integer offsets the port's plain backward is held against the Pallas
backward in interpret mode instead, on the warped stack.

Tolerances: f32, sums of up to 24 samples in another order (and in chunks
on the JAX side), outputs of order 1 -> 1e-5 of the output's scale; the
warp itself, four taps per sample in the same order on both sides -> 1e-6
absolute in f32 and one bf16 ulp of the scale in bf16; gradients 1e-5 of
each cotangent's scale. Modules: the bounds of ``test_torch_port_model.py``
(f32 1e-4 of scale)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.models.deformable import MSDeformAttn as JaxAttn
from mvdetr_tpu.models.world_feat.modules import DeformTransWorldFeat as JaxWorldFeat
from mvdetr_tpu.ops.msda_warped import ms_deform_attn_warped as jax_warped
from mvdetr_tpu.ops.msda_warped import shadow_warp_stack as jax_shadow_warp_stack
from mvdetr_tpu.ops.pallas.msda_kernel_bwd import msda_windowed_pallas_bwd
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.deformable import MSDeformAttn, radial_offset_bias
from mvdetr_tpu_torch.models.world_feat.modules import resolve_attn_mode
from mvdetr_tpu_torch.ops.msda_warped import ms_deform_attn_warped, shadow_coords, shadow_warp_stack
from mvdetr_tpu_torch.ops.msda_windowed import ms_deform_attn_windowed_bwd, windowed_attention

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, IMG_REDUCE = 2, 12
RADIUS = 4
F32_TOL = 1e-4


def _shadow_map(n_points=8):
    """The synthetic rig's reference map ``[H*W, L, P, 2]`` on its 12x24
    encoder grid, from the port's rig; equal to the JAX rig's."""
    ref = make_synthetic_rig(**RIG).reference_points(world_reduce=WORLD_REDUCE, downsample=2, n_points=n_points)
    jref = jax_make_rig(**RIG).reference_points(world_reduce=WORLD_REDUCE, downsample=2, n_points=n_points)
    np.testing.assert_array_equal(ref, jref)
    return ref


def _smooth_map(h, w, l, p, seed):
    """A smooth random reference map: an affine displacement of the identity
    grid per (level, point), as the JAX package's own oracle tests use."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.linspace(0.5, h - 0.5, h) / h, np.linspace(0.5, w - 0.5, w) / w, indexing="ij")
    ident = np.stack([xs, ys], -1).reshape(-1, 2)
    ref = np.zeros((h * w, l, p, 2), np.float32)
    for li in range(l):
        for pi in range(p):
            a = np.eye(2) + rng.normal(0, 0.15 / 4, (2, 2))
            ref[:, li, pi] = ident @ a.T + rng.normal(0, 0.15, 2)
    return ref


def _inputs(rng, b, c, l, h, w, m, d, p, lo, hi):
    value = rng.standard_normal((b, l, h, w, m, d)).astype(np.float32)
    off = rng.uniform(lo, hi, (b, c, h, w, m, l, p, 2)).astype(np.float32)
    logits = rng.standard_normal((b, c, h, w, m, l * p)).astype(np.float32)
    wgt = np.exp(logits - logits.max(-1, keepdims=True))
    wgt = (wgt / wgt.sum(-1, keepdims=True)).reshape(b, c, h, w, m, l, p).astype(np.float32)
    return value, off, wgt


def _off_integer(rng, shape, radius):
    """Offsets inside +-R at least 0.1 from every integer."""
    whole = rng.integers(-radius, radius, shape)
    return (whole + rng.uniform(0.1, 0.9, shape)).astype(np.float32)


def _close(ours, ref, rel):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours, np.float32)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


# ---------------------------------------------------------------- the shadow warp
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shadow_warp_stack_matches_jax(dtype):
    """The warped stack at the rig's 8-point map, B=2, in (l, p) order."""
    ref = _shadow_map()
    h, w = 12, 24
    rng = np.random.default_rng(0)
    value = rng.standard_normal((2, 3, h, w, 2, 8)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jout = np.asarray(jax_shadow_warp_stack(jnp.asarray(value, jd), ref).astype(jnp.float32))
    ours = shadow_warp_stack(torch.from_numpy(value).to(td), shadow_coords(ref, h, w))
    assert ours.shape == (2, 24, h, w, 2, 8) and ours.dtype == td
    if dtype == "bfloat16":
        scale = float(np.abs(jout).max())
        np.testing.assert_allclose(ours.float().numpy(), jout, rtol=0, atol=2.0 ** (np.floor(np.log2(scale)) - 7))
    else:
        np.testing.assert_allclose(ours.numpy(), jout, rtol=0, atol=1e-6)
    # the two z=0 heights of the 8 are the identity: the stack repeats the value there
    zs_identity = [i for i in range(8) if np.allclose(ref[:, 0, i], ref[:, 0, 2], atol=0)]
    assert len(zs_identity) >= 2


def test_shadow_warp_stack_gradient_matches_jax():
    """The warp's backward (``warp_scatter_accumulate``; the one-hot product
    on the CPU) against ``jax.vjp`` of the JAX function, in f32."""
    ref = _shadow_map()
    h, w = 12, 24
    rng = np.random.default_rng(1)
    value = rng.standard_normal((2, 3, h, w, 2, 8)).astype(np.float32)
    g = rng.standard_normal((2, 24, h, w, 2, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_shadow_warp_stack(v, ref), jnp.asarray(value))
    (jgrad,) = vjp(jnp.asarray(g))
    v = torch.from_numpy(value).requires_grad_()
    shadow_warp_stack(v, shadow_coords(ref, h, w)).backward(torch.from_numpy(g))
    _close(v.grad, jgrad, 1e-5)


# ---------------------------------------------------------------- the attention
@pytest.mark.parametrize("levels,points", [(2, 4), (3, 8)])
def test_warped_forward_matches_jax(levels, points):
    """L*P = 8 (one JAX call) at a smooth random map, and L*P = 24 (three
    JAX chunks of 8) at the rig's shadow map; offsets reach 1.5 cells past
    the clamp; C = 2 camera copies of the queries."""
    h, w = 12, 24
    ref = _shadow_map() if points == 8 else _smooth_map(h, w, levels, points, seed=3)
    rng = np.random.default_rng(2)
    value, off, wgt = _inputs(rng, 2, 2, levels, h, w, 4, 8, points, -RADIUS - 1.5, RADIUS + 1.5)
    jout = jax_warped(jnp.asarray(value), ref, jnp.asarray(off), jnp.asarray(wgt), radius=RADIUS, use_pallas=False)
    ours = ms_deform_attn_warped(torch.from_numpy(value), shadow_coords(ref, h, w), torch.from_numpy(off),
                                 torch.from_numpy(wgt), radius=RADIUS)
    assert ours.shape == (2, 2 * h * w, 32) and ours.dtype == torch.float32
    _close(ours, jout, 1e-5)


def test_warped_gradients_match_jax_vjp():
    """Value, offset and weight cotangents at the rig's shadow map (L*P =
    24), offsets inside +-R and away from integers."""
    h, w = 12, 24
    ref = _shadow_map()
    rng = np.random.default_rng(4)
    value, _, wgt = _inputs(rng, 1, 2, 3, h, w, 4, 8, 8, 0, 1)
    off = _off_integer(rng, (1, 2, h, w, 4, 3, 8, 2), RADIUS)
    g = rng.standard_normal((1, 2 * h * w, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda v, o, wg: jax_warped(v, ref, o, wg, radius=RADIUS, use_pallas=False),
                     jnp.asarray(value), jnp.asarray(off), jnp.asarray(wgt))
    jgrads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (value, off, wgt)]
    ms_deform_attn_warped(ts[0], shadow_coords(ref, h, w), ts[1], ts[2], radius=RADIUS).backward(torch.from_numpy(g))
    for name, t, jg in zip(("value", "offsets", "weights"), ts, jgrads):
        assert float(np.abs(np.asarray(jg)).max()) > 0, name
        _close(t.grad, jg, 1e-5)


def test_warped_backward_at_integer_offsets_matches_pallas():
    """At the radial init of 8 points (rescaled by R/P = 0.5: multiples of
    0.5, half of them integers) shifted by integers, the port's plain
    backward on the warped stack follows the Pallas backward (interpret
    mode, f32 products): exactly zero offset cotangents at the integers."""
    h, w, m, d, l, p = 6, 10, 2, 16, 3, 8
    ref = _smooth_map(h, w, l, p, seed=5)
    rng = np.random.default_rng(6)
    value, _, wgt = _inputs(rng, 1, 2, l, h, w, m, d, p, 0, 1)
    off = (radial_offset_bias(m, l, p, max_radius=RADIUS).reshape(m, l, p, 2)
           + rng.integers(-2, 3, (1, 2, h, w, m, l, p, 2))).astype(np.float32)
    stack = shadow_warp_stack(torch.from_numpy(value), shadow_coords(ref, h, w))
    off_lp = torch.from_numpy(off).reshape(1, 2, h, w, m, l * p, 1, 2)
    wgt_lp = torch.from_numpy(wgt).reshape(1, 2, h, w, m, l * p, 1)
    g = rng.standard_normal((1, 2, h, w, m * d)).astype(np.float32)
    ours = ms_deform_attn_windowed_bwd(stack, off_lp, wgt_lp, torch.from_numpy(g), RADIUS)
    pallas = msda_windowed_pallas_bwd(jnp.asarray(stack.numpy()), jnp.asarray(off_lp.numpy()),
                                      jnp.asarray(wgt_lp.numpy()), jnp.asarray(g), RADIUS,
                                      kernel_dtype=jnp.float32, interpret=True)
    for name, a, b in zip(("g_value", "g_offsets", "g_weights"), ours, pallas):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=5e-5, err_msg=name)
    exact = off_lp == torch.round(off_lp)
    assert float(exact.float().mean()) > 0.3 and int((ours[1][exact] != 0).sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warped_equals_windowed_for_identity_maps(dtype):
    """At n_points 4 with the exact identity map every pseudo-level of the
    stack is its level's value, and the (l, p) sum runs in the windowed
    order: warped and windowed attention give the same outputs and offset
    and weight cotangents. The value cotangent too in f32; in bf16 the
    warped path rounds each pseudo-level's cotangent to bf16 before the
    warp's adjoint adds the P of a level and rounds again (windowed: one
    rounding of the f32 sum), so there it is held within 2^-6 of its scale."""
    h, w, l, p = 7, 11, 3, 4
    ys, xs = np.meshgrid(np.linspace(0.5, h - 0.5, h) / h, np.linspace(0.5, w - 0.5, w) / w, indexing="ij")
    ident = np.tile(np.stack([xs, ys], -1).reshape(-1, 1, 1, 2), (1, l, p, 1)).astype(np.float32)
    rng = np.random.default_rng(7)
    value, off, wgt = _inputs(rng, 2, 3, l, h, w, 2, 8, p, -RADIUS - 1.0, RADIUS + 1.0)
    g = torch.from_numpy(rng.standard_normal((2, 3 * h * w, 16)).astype(np.float32))
    grads = []
    for warped in (True, False):
        ts = [torch.from_numpy(value).to(dtype).requires_grad_(), torch.from_numpy(off).requires_grad_(),
              torch.from_numpy(wgt).requires_grad_()]
        if warped:
            out = ms_deform_attn_warped(ts[0], shadow_coords(ident, h, w), ts[1], ts[2], radius=RADIUS)
        else:
            out = windowed_attention(ts[0], ts[1], ts[2], radius=RADIUS)
        out.backward(g)
        grads.append([out.detach()] + [t.grad.float() for t in ts])
    for i, (a, b) in enumerate(zip(*grads)):
        rel = 2.0**-6 if i == 1 and dtype == torch.bfloat16 else 1e-6
        torch.testing.assert_close(a, b, rtol=0, atol=rel * max(1.0, float(b.abs().max())))


# ---------------------------------------------------------------- modules
@pytest.fixture(scope="module")
def jax_variables():
    """The JAX model's variables at n_points 8 from a seed, with seeded noise
    on the zero offset and attention-weight kernels."""
    jax_rig = jax_make_rig(**RIG)
    jm = JaxMVDeTr.from_rig(jax_rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, n_points=8)
    imgs = jnp.zeros((1, 3, 64, 106, 3), jnp.uint8)
    aff = jnp.tile(jnp.eye(3), (1, 3, 1, 1))
    var = jax.jit(lambda k: jm.init({"params": k}, imgs, aff, train=False))(jax.random.PRNGKey(3))
    r = np.random.default_rng(0)

    def f(path, x):
        key = jax.tree_util.keystr(path)
        x = np.array(x)
        if ("sampling_offsets" in key or "attention_weights" in key) and "kernel" in key:
            return x + r.normal(0, 0.05, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, {"params": var["params"], "batch_stats": var["batch_stats"]})


def test_msdeform_attn_warped_matches_jax(jax_variables):
    """One encoder layer's attention at n_points 8 on tokens of the 3-camera
    12x24 grid: the JAX module takes the tiled map per query, the port the
    static map at construction."""
    hs, ws = 12, 24
    ref = _shadow_map()
    ref_q = np.tile(ref, (3, 1, 1, 1))  # [C*H*W, L, P, 2]: the camera copies, as from_rig builds it
    lp = jax_variables["params"]["world_feat"]["encoder"]["layer0"]["self_attn"]
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 3 * hs * ws, 128)).astype(np.float32)
    src = rng.standard_normal((2, 3 * hs * ws, 128)).astype(np.float32)
    jattn = JaxAttn(128, 3, 8, 8, mode="warped", radius=RADIUS)
    jref = jnp.broadcast_to(jnp.asarray(ref_q)[None], (2,) + ref_q.shape)
    jout, diag = jattn.apply({"params": lp}, jnp.asarray(q), jref, jnp.asarray(src), ((hs, ws),) * 3,
                             mutable=["diagnostics"])
    port = MSDeformAttn(128, 3, 8, 8, mode="warped", radius=RADIUS, reference_points=ref_q, spatial_shape=(hs, ws))
    sd = {k.split("self_attn.", 1)[1]: v for k, v in from_jax_variables(jax_variables, device="cpu").items()
          if k.startswith("world_feat.encoder.layers.0.self_attn.")}
    port.load_state_dict(sd)
    assert "shadow_xy" not in port.state_dict()
    with torch.no_grad():
        ours, clip = port(torch.from_numpy(q), torch.from_numpy(src), (hs, ws))
    _close(ours, jout, F32_TOL)
    np.testing.assert_allclose(float(clip), float(jax.tree.leaves(diag)[0]), atol=1e-6)
    assert 0.0 < float(clip) < 1.0


def test_msdeform_attn_takes_a_map_without_points_and_refuses_gather():
    """A ``[Q, L, 2]`` map is tiled to the P points; a mode that does not
    exist raises (gather mode runs: ``test_torch_port_gather.py``)."""
    hs, ws = 4, 5
    ref = _smooth_map(hs, ws, 2, 1, seed=9)[:, :, 0]  # [H*W, L, 2]
    a = MSDeformAttn(16, 2, 2, 8, mode="warped", reference_points=ref, spatial_shape=(hs, ws))
    b = MSDeformAttn(16, 2, 2, 8, mode="warped", reference_points=np.tile(ref[:, :, None], (1, 1, 8, 1)),
                     spatial_shape=(hs, ws))
    assert torch.equal(a.shadow_xy, b.shadow_xy) and a.shadow_xy.shape == (2, 2, hs * ws * 8)
    with pytest.raises(ValueError, match="unknown MSDeformAttn mode 'bilinear'"):
        MSDeformAttn(16, 2, 2, 4, mode="bilinear")
    with pytest.raises(ValueError, match="reference_points"):
        MSDeformAttn(16, 2, 2, 8, mode="warped")


def test_shadow_transformer_matches_jax(jax_variables):
    """``DeformTransWorldFeat`` at n_points 8 (warped, three encoder layers),
    and its per-layer offset_clip_fraction."""
    jax_rig = jax_make_rig(**RIG)
    h, w = jax_rig.Rworld_shape(WORLD_REDUCE)
    ref = np.tile(_shadow_map(), (3, 1, 1, 1))
    jwf = JaxWorldFeat(3, (h, w), n_points=8, reference_points=ref)
    x = np.random.default_rng(10).standard_normal((2, 3, h, w, 128)).astype(np.float32)
    apply = jax.jit(lambda v, x: jwf.apply(v, x, False, mutable=["diagnostics"]))
    jout, diag = apply({"params": jax_variables["params"]["world_feat"]}, jnp.asarray(x))
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, n_points=8,
                           device="cpu")
    port.load_state_dict(from_jax_variables(jax_variables, device="cpu"))
    assert port.world_feat.mode == "warped"
    with torch.no_grad():
        ours, clips = port.world_feat(torch.from_numpy(x))
    _close(ours, jout, F32_TOL)
    np.testing.assert_allclose([float(c) for c in clips], np.asarray(jax.tree.leaves(diag)), atol=1e-6)


@pytest.mark.parametrize("rig_name", ["synthetic", "wildtrack-width"])
@pytest.mark.parametrize("n_points", [4, 8])
@pytest.mark.parametrize("attn_mode", ["auto", "warped"])
def test_resolve_attn_mode_matches_jax(rig_name, n_points, attn_mode):
    """``auto`` gives windowed at n_points 4 and warped at 8, on the
    synthetic rig and on the Wildtrack-width rig of ``chip_smoke.bench_rig``;
    an explicit mode is kept. The JAX rule is ``DeformTransWorldFeat._resolve_mode``."""
    from chip_smoke import bench_rig

    if rig_name == "synthetic":
        rig, jrig, world_reduce = make_synthetic_rig(**RIG), jax_make_rig(**RIG), WORLD_REDUCE
    else:
        rig = bench_rig()
        jrig = jax_make_rig(num_cam=7, img_shape=(1080, 1920), worldgrid_shape=(480, 1440), cell_meters=0.025,
                            indexing="ij", worldcoord_unit=0.01, origin_offset=(-300.0, -900.0),
                            camera_height_m=6.0, camera_margin_m=4.0, name="BenchWildtrack")
        world_reduce = 4
    hs, ws = (s // 2 for s in rig.Rworld_shape(world_reduce))
    ref = np.tile(rig.reference_points(world_reduce=world_reduce, downsample=2, n_points=n_points),
                  (rig.num_cam, 1, 1, 1))
    jref = np.tile(jrig.reference_points(world_reduce=world_reduce, downsample=2, n_points=n_points),
                   (rig.num_cam, 1, 1, 1))
    jmode = JaxWorldFeat(rig.num_cam, rig.Rworld_shape(world_reduce), n_points=n_points, reference_points=jref,
                         attn_mode=attn_mode)._resolve_mode(hs, ws)
    ours = resolve_attn_mode(attn_mode, ref, hs, ws)
    assert ours == jmode
    assert ours == ("windowed" if attn_mode == "auto" and n_points == 4 else "warped")
