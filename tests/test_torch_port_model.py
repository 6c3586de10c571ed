"""Every module of the serving slice, and the whole forward, against the JAX
package: the JAX model is initialised from a seed, its variables are carried
over with ``from_jax_variables``, and both run on the same numpy inputs at
inference (``train=False``).

Tolerances: f32 runs the same arithmetic with sums in another order; through
the ~20-layer trunk that stays below 1e-4 of outputs of order 1-10 (observed
~1e-5), so atol = 1e-4 * max(1, max|ref|). bf16 rounds at the same places on
both sides but to different neighbours now and then; a flipped bf16 rounding
(2^-8 relative) can carry through a few layers, so the bound is 4e-2 of the
output scale (observed ~1-2e-2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.interop import convert_reference_state_dict
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.models.deformable import DeformableEncoderLayer as JaxLayer
from mvdetr_tpu.models.deformable import MSDeformAttn as JaxAttn
from mvdetr_tpu.models.heads import OutputHead as JaxHead
from mvdetr_tpu.models.resnet import ResNetFeatures as JaxResNet
from mvdetr_tpu.models.world_feat.modules import DeformTransWorldFeat as JaxWorldFeat
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, IMG_REDUCE = 2, 12
F32_TOL, BF16_TOL = 1e-4, 4e-2


def _close(ours: torch.Tensor, ref, rel: float) -> None:
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def _perturb(variables, seed=0):
    """Seeded numpy noise on what the JAX init leaves trivial: the zero
    offset/attention-weight kernels (offsets then vary per query and some
    bind the clamp), BatchNorm statistics and the norm scales."""
    r = np.random.default_rng(seed)

    def f(path, x):
        key = jax.tree_util.keystr(path)
        x = np.array(x)
        if ("sampling_offsets" in key or "attention_weights" in key) and "kernel" in key:
            return x + r.normal(0, 0.05, x.shape).astype(np.float32)
        if key.endswith("['mean']"):
            return r.normal(0, 0.1, x.shape).astype(np.float32)
        if key.endswith("['var']"):
            return r.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if key.endswith("['scale']"):
            return r.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, variables)


@pytest.fixture(scope="module")
def setup():
    jax_rig = jax_make_rig(**RIG)
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 3, 64, 106, 3), dtype=np.uint8)
    aff = np.tile(np.eye(3, dtype=np.float32), (2, 3, 1, 1))
    aff[0, 1] = [[1.1, 0.05, -6.0], [-0.03, 0.95, 4.0], [0, 0, 1]]  # non-identity augmentation affine
    jm = JaxMVDeTr.from_rig(jax_rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE)
    init = jax.jit(lambda k: jm.init({"params": k}, jnp.asarray(imgs), jnp.asarray(aff), train=False))
    var = init(jax.random.PRNGKey(3))
    var = _perturb({"params": var["params"], "batch_stats": var["batch_stats"]})
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                           device="cpu")
    port.load_state_dict(from_jax_variables(var, device="cpu"))
    return dict(jax_rig=jax_rig, jm=jm, var=var, port=port, imgs=imgs, aff=aff, rng=rng)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_bridge_round_trip_is_exact(setup):
    """convert_reference_state_dict(port.state_dict()) gives back the JAX
    variables bit for bit: the port's names are the reference checkpoint's."""
    back = convert_reference_state_dict(setup["port"].state_dict())
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(setup["var"]))
    assert flat_back.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_back[k]), np.asarray(v), err_msg=jax.tree_util.keystr(k))


def test_resnet_trunk_matches_jax(setup):
    x = setup["rng"].standard_normal((2, 40, 56, 3)).astype(np.float32)
    v = {"params": setup["var"]["params"]["base"], "batch_stats": setup["var"]["batch_stats"]["base"]}
    ref = jax.jit(lambda v, x: JaxResNet().apply(v, x, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        ours = setup["port"].base(_nchw(x)).permute(0, 2, 3, 1)
    _close(ours, ref, F32_TOL)


@pytest.mark.parametrize("head", ["img_heatmap", "img_offset", "world_offset"])
def test_output_heads_match_jax(setup, head):
    x = setup["rng"].standard_normal((2, 5, 7, 128)).astype(np.float32)
    out_dim = 1 if head.endswith("heatmap") else 2
    ref = JaxHead(out_dim).apply({"params": setup["var"]["params"][head]}, jnp.asarray(x))
    with torch.no_grad():
        ours = getattr(setup["port"], head)(_nchw(x))
    assert ours.dtype == torch.float32
    _close(ours, ref, F32_TOL)


def test_output_head_with_neck_matches_jax(rng):
    """The outfeat_dim > 0 head: Conv3x3 + ReLU + Conv1x1 as ``<head>.0/.2``."""
    from mvdetr_tpu_torch.models.heads import OutputHead

    x = rng.standard_normal((1, 6, 9, 16)).astype(np.float32)
    jhead = JaxHead(2, feat_dim=8, final_bias=-2.19)
    v = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    head = OutputHead(16, 2, feat_dim=8, final_bias=-2.19)
    conv = {"0": v["neck"], "2": v["proj"]}
    head.load_state_dict({f"{i}.{name}": torch.from_numpy(np.array(val)) for i, node in conv.items()
                          for name, val in (("weight", np.transpose(node["kernel"], (3, 2, 0, 1))),
                                            ("bias", node["bias"]))})
    with torch.no_grad():
        _close(head(_nchw(x)), jhead.apply({"params": v}, jnp.asarray(x)), F32_TOL)


def _world_inputs(setup):
    h, w = setup["jax_rig"].Rworld_shape(WORLD_REDUCE)
    return setup["rng"].standard_normal((2, 3, h, w, 128)).astype(np.float32)


def _jax_world_feat(setup):
    ref = setup["jax_rig"].reference_points(world_reduce=WORLD_REDUCE, downsample=2, n_points=4)
    ref = np.tile(ref, (3, 1, 1, 1))
    return JaxWorldFeat(3, setup["jax_rig"].Rworld_shape(WORLD_REDUCE), reference_points=ref)


def test_deform_trans_world_feat_matches_jax(setup):
    """Downsample, level embedding, 3 windowed encoder layers, camera-major
    merge and the bilinear 2x resize (F.interpolate vs jax.image.resize)."""
    x = _world_inputs(setup)
    jwf = _jax_world_feat(setup)
    apply = jax.jit(lambda v, x: jwf.apply(v, x, False, mutable=["diagnostics"]))
    ref, diag = apply({"params": setup["var"]["params"]["world_feat"]}, jnp.asarray(x))
    with torch.no_grad():
        ours, clips = setup["port"].world_feat(torch.from_numpy(x))
    assert setup["port"].world_feat.mode == "windowed"
    _close(ours, ref, F32_TOL)
    np.testing.assert_allclose([float(c) for c in clips], np.asarray(jax.tree.leaves(diag)), atol=1e-6)


def test_encoder_layer_and_attention_match_jax(setup):
    """One post-norm encoder layer, and its MSDeformAttn alone, on tokens of
    the 3-camera 12x24 encoder grid."""
    h, w = setup["jax_rig"].Rworld_shape(WORLD_REDUCE)
    hs, ws = h // 2, w // 2
    src = setup["rng"].standard_normal((2, 3 * hs * ws, 128)).astype(np.float32)
    pos = setup["rng"].standard_normal((1, 3 * hs * ws, 128)).astype(np.float32)
    shapes = ((hs, ws),) * 3
    ref_pts = jnp.zeros((2, 3 * hs * ws, 3, 4, 2))  # ignored in windowed mode
    lp = setup["var"]["params"]["world_feat"]["encoder"]["layer0"]
    port_layer = setup["port"].world_feat.encoder.layers[0]

    jlayer = JaxLayer(128, 512, 0.1, 3, 8, 4, mode="windowed", radius=4)
    ref = jlayer.apply({"params": lp}, jnp.asarray(src), jnp.asarray(pos), ref_pts, shapes, False,
                       mutable=["diagnostics"])[0]
    with torch.no_grad():
        ours, _ = port_layer(torch.from_numpy(src), torch.from_numpy(pos), (hs, ws))
    _close(ours, ref, F32_TOL)

    q = src + pos
    jattn = JaxAttn(128, 3, 8, 4, mode="windowed", radius=4)
    ref_attn = jattn.apply({"params": lp["self_attn"]}, jnp.asarray(q), ref_pts, jnp.asarray(src), shapes,
                           mutable=["diagnostics"])[0]
    with torch.no_grad():
        ours_attn, clip = port_layer.self_attn(torch.from_numpy(q), torch.from_numpy(src), (hs, ws))
    _close(ours_attn, ref_attn, F32_TOL)
    assert 0.0 < float(clip) < 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_forward_matches_jax(setup, dtype):
    """uint8 frames with one non-identity augmentation affine, through the
    whole model at inference, f32 and bf16 compute."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    td = torch.bfloat16 if dtype == "bfloat16" else None
    jm = JaxMVDeTr.from_rig(setup["jax_rig"], world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, compute_dtype=jd)
    apply = jax.jit(lambda v, i, a: jm.apply(v, i, a, train=False, mutable=["diagnostics"]))
    ref, diag = apply(setup["var"], jnp.asarray(setup["imgs"]), jnp.asarray(setup["aff"]))
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                           compute_dtype=td, device="cpu")
    port.load_state_dict(setup["port"].state_dict())
    with torch.no_grad():
        ours, clips = port(torch.from_numpy(setup["imgs"]), torch.from_numpy(setup["aff"]))
    tol = BF16_TOL if td is not None else F32_TOL
    for o, r in zip((*ours[0], *ours[1]), jax.tree.leaves(ref)):
        assert o.dtype == torch.float32  # head logits stay f32
        _close(o, r, tol)
    np.testing.assert_allclose([float(c) for c in clips], np.asarray(jax.tree.leaves(diag)), atol=1e-2)


def test_training_mode_and_other_variants_raise(setup):
    """Training mode draws dropout masks from a generator that the train
    step sets: called without one, the forward raises. The ``conv`` and
    ``trans`` fusions, which raised at construction until they were ported,
    build and run the same frames as JAX's at inference, in f32 (their own
    tests are in ``test_torch_port_variants.py``)."""
    port = setup["port"]
    try:
        with pytest.raises(ValueError, match="generator"):
            port.train()(torch.from_numpy(setup["imgs"]), torch.from_numpy(setup["aff"]))
    finally:
        port.eval()
    for arch in ("conv", "trans"):
        ours_model = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, world_feat_arch=arch,
                                     device="cpu", seed=3)
        jm = JaxMVDeTr.from_rig(setup["jax_rig"], world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                                world_feat_arch=arch)
        variables = convert_reference_state_dict({k: v.numpy() for k, v in ours_model.state_dict().items()})
        ref = jax.jit(lambda v, i, a: jm.apply(v, i, a, train=False))(variables, jnp.asarray(setup["imgs"]),
                                                                        jnp.asarray(setup["aff"]))
        with torch.no_grad():
            ours, clips = ours_model(torch.from_numpy(setup["imgs"]), torch.from_numpy(setup["aff"]))
        assert clips == []
        for o, r in zip((*ours[0], *ours[1]), jax.tree.leaves(ref)):
            _close(o, r, F32_TOL)
