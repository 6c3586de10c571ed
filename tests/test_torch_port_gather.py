"""``gather`` attention against the JAX package, on the CPU:

- the ops (``ops/sampling.py::bilinear_gather``, ``ops/msda.py``'s
  ``ms_deform_attn`` and ``ms_deform_attn_same_shape``) against the jitted
  JAX functions: f32 within 1e-6 of the output scale, bf16 within one bf16
  ulp of the scale (XLA on the CPU may keep an f32 sum where the port rounds);
- ``_GatherAttnFn``'s three gradients against ``jax.vjp`` of
  ``ms_deform_attn_same_shape``, in f32 at non-integer offsets, within 1e-5
  of each gradient's scale, and its backward free of scatters (no
  ``index_add``, ``scatter_add``, ``index_put(accumulate=True)``);
- the pixel coordinates: XLA contracts ``ref + off / [W, H]`` and
  ``loc * W - 0.5`` into fused multiply-adds on the CPU, and the port does
  the same, so at the radial init (most offsets integers, each ``x`` within
  an ulp of an integer) the locations and ``floor(x)`` agree bit for bit;
- ``MSDeformAttn(mode="gather")`` with a shadow map and with the grid map,
  forward and gradients, at the radial init too;
- the ``deform_trans`` model in gather mode on the 3-camera rig of
  ``test_torch_port_model.py``: the forward at inference in f32 (1e-4 of
  scale) and bf16 (4e-2), and one train step in f32 (loss to 1e-5 relative,
  every gradient leaf within 1e-2 in relative L2, ``test_torch_port_train.py``'s
  bounds), with no ``offset_clip_fraction`` (JAX sows none in gather mode);
- the model with ``warp_convention="kornia"``, the reference checkpoint's
  resampling, against JAX's;
- one tiny CPU epoch of ``python -m mvdetr_tpu_torch.cli --attn_mode gather``.
"""

import functools
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.interop import convert_reference_state_dict
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.models.deformable import MSDeformAttn as JaxAttn
from mvdetr_tpu.models.deformable import grid_reference_points as jax_grid_reference_points
from mvdetr_tpu.models.world_feat import modules as jax_world_feat_modules
from mvdetr_tpu.ops import msda as jax_msda
from mvdetr_tpu.ops.sampling import bilinear_gather as jax_bilinear_gather
from mvdetr_tpu.train import create_train_state as jax_create_train_state
from mvdetr_tpu.train import train_step as jax_train_step
from mvdetr_tpu.train.trainer import supervised_loss as jax_supervised_loss
from mvdetr_tpu_torch import cli
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.deformable import MSDeformAttn, grid_reference_points, sampling_locations
from mvdetr_tpu_torch.ops import msda
from mvdetr_tpu_torch.ops.sampling import bilinear_gather
from mvdetr_tpu_torch.train import create_train_state, train_step
from _torch_port import few_torch_threads, synthetic_train_batch  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, IMG_REDUCE = 2, 12
F32_TOL, BF16_TOL = 1e-4, 4e-2
LR, TOTAL_STEPS = 5e-4, 100
LOSS_KEYS = ("loss", "w_hm", "w_off", "img_hm", "img_off", "img_wh")
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SCATTERS = ("index_add", "scatter_add", "scatter_reduce", "index_put", "_index_put_impl")


def _op_tol(ref, dtype: str) -> float:
    """1e-6 of the scale in f32; one bf16 ulp of the scale in bf16."""
    scale = max(1.0, float(np.abs(ref).max()))
    return 1e-6 * scale if dtype == "float32" else 2.0 ** (np.floor(np.log2(scale)) - 7)


def _close(ours, ref, rel):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def _inputs(seed, b=2, levels=((6, 9), (6, 9), (6, 9)), m=2, d=4, p=3, q=25):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in levels)
    value = rng.standard_normal((b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (b, q, m, len(levels), p, 2)).astype(np.float32)  # some taps outside
    wgt = rng.uniform(0, 1, (b, q, m, len(levels), p)).astype(np.float32)
    return value, loc, wgt


class _OpLog(TorchDispatchMode):
    """The aten ops dispatched while active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bilinear_gather_matches_jax(dtype):
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(1)
    h, w = 7, 11
    flat = rng.standard_normal((3, h * w, 5)).astype(np.float32)
    x = rng.uniform(-2.0, w + 1.0, (3, 40)).astype(np.float32)
    y = rng.uniform(-2.0, h + 1.0, (3, 40)).astype(np.float32)
    ref = jax.jit(lambda f, a, b_: jax_bilinear_gather(f, a, b_, h, w))(jnp.asarray(flat).astype(jd), x, y)
    ref = np.asarray(ref.astype(jnp.float32))
    ours = bilinear_gather(torch.from_numpy(flat).to(td), torch.from_numpy(x), torch.from_numpy(y), h, w)
    assert ours.dtype == td and ours.shape == (3, 40, 5)
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0, atol=_op_tol(ref, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ms_deform_attn_matches_jax(dtype):
    """Per-level gathers, over levels of three different shapes."""
    td, jd = DTYPES[dtype]
    levels = ((6, 9), (4, 5), (3, 7))
    value, loc, wgt = _inputs(2, levels=levels)
    ref = jax.jit(lambda v, lc, wg: jax_msda.ms_deform_attn(v, levels, lc, wg))(
        jnp.asarray(value).astype(jd), loc, jnp.asarray(wgt).astype(jd))
    ref = np.asarray(ref.astype(jnp.float32))
    ours = msda.ms_deform_attn(torch.from_numpy(value).to(td), levels, torch.from_numpy(loc),
                               torch.from_numpy(wgt).to(td))
    assert ours.dtype == td
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0, atol=_op_tol(ref, dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ms_deform_attn_same_shape_matches_jax(dtype):
    """The flat same-shape gather, and the dispatching entry on a CPU tensor."""
    td, jd = DTYPES[dtype]
    value, loc, wgt = _inputs(3)
    ref = jax.jit(lambda v, lc, wg: jax_msda.ms_deform_attn_same_shape(v, (6, 9), 3, lc, wg))(
        jnp.asarray(value).astype(jd), loc, jnp.asarray(wgt).astype(jd))
    ref = np.asarray(ref.astype(jnp.float32))
    args = (torch.from_numpy(value).to(td), (6, 9), 3, torch.from_numpy(loc), torch.from_numpy(wgt).to(td))
    ours = msda.ms_deform_attn_same_shape(*args)
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0, atol=_op_tol(ref, dtype))
    assert torch.equal(msda.ms_deform_attn_gather(*args), ours)


def test_gather_gradients_match_jax_vjp_and_scatter_nothing():
    """f32, non-integer offsets: value, locations and weights cotangents
    within 1e-5 of each one's scale; the backward dispatches no scatter."""
    value, loc, wgt = _inputs(4)
    g = np.random.default_rng(5).standard_normal((2, 25, 8)).astype(np.float32)
    fn = jax.jit(lambda v, lc, wg: jax_msda.ms_deform_attn_same_shape(v, (6, 9), 3, lc, wg))
    _, vjp = jax.vjp(fn, jnp.asarray(value), jnp.asarray(loc), jnp.asarray(wgt))
    refs = vjp(jnp.asarray(g))
    tv, tl, tw = (torch.from_numpy(a).requires_grad_() for a in (value, loc, wgt))
    out = msda.ms_deform_attn_gather(tv, (6, 9), 3, tl, tw)
    with _OpLog() as log:
        out.backward(torch.from_numpy(g))
    for name, ours, ref in zip(("value", "locations", "weights"), (tv.grad, tl.grad, tw.grad), refs):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())),
                                   err_msg=name)
    assert not [op for op in log.ops if any(s in op for s in SCATTERS)], sorted(set(log.ops))


def _radial_setup(levels=3, h=5, w=8, points=4, heads=8, shadow=True, seed=0):
    """A JAX gather-mode MSDeformAttn at its init (zero offset kernel: every
    offset is the radial bias), with a shadow map ``[Q, L, P, 2]`` (the
    identity grid moved by whole cells, so every ``x`` lands within an ulp
    of an integer) or the grid map ``[Q, L, 2]``; inputs from a seed."""
    rng = np.random.default_rng(seed)
    q = levels * h * w
    if shadow:
        ref = np.tile(jax_grid_reference_points(((h, w),) * levels)[:, :, None, :], (1, 1, points, 1))
        ref = ref + rng.integers(-1, 2, ref.shape[:3] + (2,)) / np.array([w, h])
        ref = ref.astype(np.float32)
    else:
        ref = jax_grid_reference_points(((h, w),) * levels)
    src = rng.standard_normal((2, q, 128)).astype(np.float32)
    query = rng.standard_normal((2, q, 128)).astype(np.float32)
    jattn = JaxAttn(128, levels, heads, points, mode="gather")
    jref = jnp.broadcast_to(jnp.asarray(ref)[None], (2,) + ref.shape)
    params = jattn.init(jax.random.PRNGKey(seed), jnp.asarray(query), jref, jnp.asarray(src), ((h, w),) * levels)
    port = MSDeformAttn(128, levels, heads, points, mode="gather", reference_points=ref)
    sd = {f"{name}.weight": torch.from_numpy(np.asarray(node["kernel"]).T.copy())
          for name, node in params["params"].items()}
    sd.update({f"{name}.bias": torch.from_numpy(np.asarray(node["bias"]).copy())
               for name, node in params["params"].items()})
    port.load_state_dict(sd)
    return dict(jattn=jattn, params=params, jref=jref, ref=ref, src=src, query=query, port=port,
                shapes=((h, w),) * levels, hw=(h, w))


@pytest.mark.parametrize("shadow", [True, False], ids=["shadow-map", "grid-map"])
def test_locations_and_floor_match_jax_bitwise_at_the_radial_init(shadow):
    """The module's sampling locations (JAX sows them) equal the port's bit
    for bit, and so does ``floor(loc * W - 0.5)``, with most offsets
    integers."""
    s = _radial_setup(shadow=shadow)
    h, w = s["hw"]
    _, inter = jax.jit(lambda p_, qq, r, src: s["jattn"].apply(p_, qq, r, src, s["shapes"], mutable=["intermediates"]))(
        s["params"], jnp.asarray(s["query"]), s["jref"], jnp.asarray(s["src"]))
    jloc = np.asarray(inter["intermediates"]["viz_sampling_locations"][0])
    port = s["port"]
    b, q = s["query"].shape[:2]
    with torch.no_grad():
        off = port.sampling_offsets(torch.from_numpy(s["query"])).reshape(b, q, 8, 3, 4, 2).float()
    assert float((off == torch.round(off)).float().mean()) > 0.5  # the radial init: mostly whole cells
    loc = sampling_locations(port.reference_points, off, h, w)
    np.testing.assert_array_equal(loc.numpy(), np.broadcast_to(jloc, loc.shape))
    jfloor = jax.jit(lambda lc: (jnp.floor(lc[..., 0] * w - 0.5), jnp.floor(lc[..., 1] * h - 0.5)))(loc.numpy())
    x, y = msda._pixel_coords(loc, h, w)
    for ours, ref in zip((x, y), jfloor):
        np.testing.assert_array_equal(torch.floor(ours).numpy(), np.moveaxis(np.asarray(ref), 2, 1).reshape(x.shape))
    near = (x - torch.round(x)).abs() < 1e-4
    assert float(near.float().mean()) > 0.5  # these are the x that a second rounding could flip


@pytest.mark.parametrize("shadow", [True, False], ids=["shadow-map", "grid-map"])
def test_msdeform_attn_gather_matches_jax(shadow):
    """Forward within 1e-6 of scale, and the gradients of the query, the
    source and every parameter within 1e-5 of scale, at the radial init
    (integer offsets: the floors agree, so the offsets' gradients do) and
    with seeded noise on the offset and attention-weight kernels."""
    s = _radial_setup(shadow=shadow, seed=1)
    for noisy in (False, True):
        params = s["params"]
        if noisy:
            r = np.random.default_rng(2)
            params = jax.tree_util.tree_map_with_path(
                lambda path, x: x + r.normal(0, 0.05, x.shape).astype(np.float32)
                if "kernel" in jax.tree_util.keystr(path) and ("offsets" in jax.tree_util.keystr(path)
                                                              or "attention" in jax.tree_util.keystr(path)) else x,
                params)
            s["port"].load_state_dict({
                **s["port"].state_dict(),
                **{f"{n}.weight": torch.from_numpy(np.asarray(params["params"][n]["kernel"]).T.copy())
                   for n in ("sampling_offsets", "attention_weights")}})
        g = np.random.default_rng(3).standard_normal(s["query"].shape).astype(np.float32)

        def jfn(p_, qq, src):
            return s["jattn"].apply(p_, qq, s["jref"], src, s["shapes"])

        jout, vjp = jax.vjp(jax.jit(jfn), params, jnp.asarray(s["query"]), jnp.asarray(s["src"]))
        jgp, jgq, jgs = vjp(jnp.asarray(g))
        port = s["port"]
        port.zero_grad()
        tq, ts = (torch.from_numpy(a).requires_grad_() for a in (s["query"], s["src"]))
        out, clip = port(tq, ts, s["hw"])
        assert clip is None
        _close(out, jout, 1e-6)
        out.backward(torch.from_numpy(g))
        _close(tq.grad, jgq, 1e-5)
        _close(ts.grad, jgs, 1e-5)
        for name, node in jgp["params"].items():
            _close(getattr(port, name).weight.grad, np.asarray(node["kernel"]).T, 1e-5)
            _close(getattr(port, name).bias.grad, node["bias"], 1e-5)


def test_msdeform_attn_gather_needs_a_fitting_map():
    with pytest.raises(ValueError, match="needs reference_points"):
        MSDeformAttn(16, 2, 2, 4, mode="gather")
    with pytest.raises(ValueError, match="does not fit"):
        MSDeformAttn(16, 2, 2, 4, mode="gather", reference_points=np.zeros((10, 3, 2), np.float32))
    attn = MSDeformAttn(16, 2, 2, 4, mode="gather", reference_points=grid_reference_points(((3, 4),) * 2))
    with pytest.raises(ValueError, match="queries"):
        attn(torch.zeros(1, 12, 16), torch.zeros(1, 24, 16), (3, 4))
    np.testing.assert_array_equal(grid_reference_points(((3, 4), (2, 5))), jax_grid_reference_points(((3, 4), (2, 5))))


def _perturb(variables, seed=0):
    """Seeded noise on the zero offset and attention-weight kernels and on
    the norm scales (``test_torch_port_train.py``'s)."""
    r = np.random.default_rng(seed)

    def f(path, x):
        key = jax.tree_util.keystr(path)
        x = np.array(x)
        if ("sampling_offsets" in key or "attention_weights" in key) and "kernel" in key:
            return x + r.normal(0, 0.05, x.shape).astype(np.float32)
        if key.endswith("['scale']"):
            return r.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, variables)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def gate():
    """The JAX deform_trans model in gather mode (dropout 0), perturbed; its
    gradients and one train step; the port's from the same variables."""
    jax_rig, rig = jax_make_rig(**RIG), make_synthetic_rig(**RIG)
    batch = synthetic_train_batch(rig, 2, WORLD_REDUCE, IMG_REDUCE, seed=5)
    jbatch = jax.tree.map(jnp.asarray, batch)
    no_dropout = functools.partial(jax_world_feat_modules.DeformTransWorldFeat, dropout=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_world_feat_modules, "DeformTransWorldFeat", no_dropout)
        jm = JaxMVDeTr.from_rig(jax_rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, attn_mode="gather")
        state = jax_create_train_state(jm, batch, lr=LR, total_steps=TOTAL_STEPS)
        var = _perturb({"params": state.params, "batch_stats": state.batch_stats})
        state = state.replace(params=var["params"], batch_stats=var["batch_stats"])
        key = jax.random.PRNGKey(0)

        def loss_fn(params):
            outputs, _ = state.apply_fn({"params": params, "batch_stats": state.batch_stats}, jbatch["imgs"],
                                        jbatch["affine_mats"], train=True, mutable=["batch_stats", "diagnostics"],
                                        rngs={"dropout": key})
            return jax_supervised_loss(outputs, jbatch)[0]

        jgrads = jax.jit(jax.grad(loss_fn))(state.params)
        _, jaux = jax_train_step(jax.tree.map(jnp.copy, state), jbatch, key)

    port = MVDeTr.from_rig(rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, attn_mode="gather",
                           encoder_dropout=0.0, device="cpu")
    port.load_state_dict(from_jax_variables(var, device="cpu"))
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    pstate = create_train_state(port, lr=LR, total_steps=TOTAL_STEPS)
    with _OpLog() as log:
        pstate, paux = train_step(pstate, batch, torch.Generator().manual_seed(0), device="cpu")
    grads = {k: v.numpy().copy() for k, v in sd.items()}
    grads.update({n: p.grad.detach().numpy().copy() for n, p in port.named_parameters()})
    return dict(var=var, state_dict=sd, port_mode=port.world_feat.mode, ops=log.ops,
                jax_aux={k: float(v) for k, v in jaux.items()}, port_aux={k: float(v) for k, v in paux.items()},
                jax_grads=_flat(jgrads), port_grads=_flat(convert_reference_state_dict(grads)["params"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_forward_matches_jax(gate, dtype):
    """uint8 frames with one non-identity augmentation affine, through the
    whole model in gather mode at inference."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    td = torch.bfloat16 if dtype == "bfloat16" else None
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 3, 64, 106, 3), dtype=np.uint8)
    aff = np.tile(np.eye(3, dtype=np.float32), (2, 3, 1, 1))
    aff[0, 1] = [[1.1, 0.05, -6.0], [-0.03, 0.95, 4.0], [0, 0, 1]]
    jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                            attn_mode="gather", compute_dtype=jd)
    ref = jax.jit(lambda v, i, a: jm.apply(v, i, a, train=False))(gate["var"], jnp.asarray(imgs), jnp.asarray(aff))
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                           attn_mode="gather", compute_dtype=td, device="cpu")
    port.load_state_dict(gate["state_dict"])
    assert port.world_feat.mode == "gather"
    assert port.world_feat.encoder.layers[0].self_attn.reference_points.shape == (3 * 12 * 24, 1, 3, 4, 2)
    with torch.no_grad():
        ours, clips = port(torch.from_numpy(imgs), torch.from_numpy(aff))
    assert clips == []
    tol = BF16_TOL if td is not None else F32_TOL
    for o, r in zip((*ours[0], *ours[1]), jax.tree.leaves(ref)):
        assert o.dtype == torch.float32
        _close(o, r, tol)


def test_train_step_matches_jax(gate):
    """The loss terms to 1e-5 relative, no offset_clip_fraction on either
    side, every gradient leaf within 1e-2 in relative L2 (the offsets' and
    attention weights' kernels nonzero), and no scatter in the step."""
    assert gate["port_mode"] == "gather"
    assert "offset_clip_fraction" not in gate["port_aux"] and "offset_clip_fraction" not in gate["jax_aux"]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(gate["port_aux"][k], gate["jax_aux"][k], rtol=1e-5, err_msg=k)
    assert gate["port_grads"].keys() == gate["jax_grads"].keys()
    bad = {}
    for k, ref in gate["jax_grads"].items():
        rel_l2 = np.linalg.norm(gate["port_grads"][k] - ref) / np.linalg.norm(ref)
        if not rel_l2 <= 1e-2:
            bad[k] = rel_l2
    assert not bad, f"gradient leaves off: {bad}"
    for proj in ("value_proj", "sampling_offsets", "attention_weights"):
        key = f"['world_feat']['encoder']['layer0']['self_attn']['{proj}']['kernel']"
        assert np.abs(gate["jax_grads"][key]).max() > 0, proj
    # the only scatters are the backwards of the regression losses' target gathers (`losses.py::
    # gather_at_indices`, one aten.gather each, in every attention mode); the warp and the attention scatter nothing
    scatters = [op for op in gate["ops"] if any(s in op for s in SCATTERS)]
    assert scatters == ["aten.scatter_add.default"] * gate["ops"].count("aten.gather.default") and scatters


def test_kornia_warp_convention_forward_matches_jax(gate):
    """``warp_convention="kornia"`` (the reference checkpoint's resampling,
    the CLI's default with ``--load_torch_ckpt``) through the whole model
    at inference, in f32."""
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (2, 3, 64, 106, 3), dtype=np.uint8)
    aff = np.tile(np.eye(3, dtype=np.float32), (2, 3, 1, 1))
    aff[1, 2] = [[0.93, -0.04, 5.0], [0.02, 1.07, -3.0], [0, 0, 1]]
    jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                            attn_mode="gather", warp_convention="kornia")
    ref = jax.jit(lambda v, i, a: jm.apply(v, i, a, train=False))(gate["var"], jnp.asarray(imgs), jnp.asarray(aff))
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                           attn_mode="gather", warp_convention="kornia", device="cpu")
    port.load_state_dict(gate["state_dict"])
    with torch.no_grad():
        ours, _ = port(torch.from_numpy(imgs), torch.from_numpy(aff))
        center = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                                 attn_mode="gather", device="cpu")
        center.load_state_dict(gate["state_dict"])
        other, _ = center(torch.from_numpy(imgs), torch.from_numpy(aff))
    for o, r in zip((*ours[0], *ours[1]), jax.tree.leaves(ref)):
        _close(o, r, F32_TOL)
    assert float((other[0][0] - ours[0][0]).abs().max()) > 1e-3  # the convention changes the BEV input


def test_cli_epoch_in_gather_mode(tmp_path):
    """One tiny CPU epoch of ``python -m mvdetr_tpu_torch.cli --attn_mode
    gather``: a checkpoint, a test pass, no clip fraction in the log."""
    argv = ["-d", "synthetic", "--device", "cpu", "--synthetic_cams", "2", "--synthetic_frames", "6",
            "--synthetic_img", "48", "96", "--synthetic_grid", "32", "64", "--world_reduce", "2",
            "--cls_thres", "0.3", "--batch_size", "2", "-j", "2", "--epochs", "1", "--attn_mode", "gather",
            "--logdir", str(tmp_path / "run")]
    saved = sys.stdout
    try:
        trainer = cli.main(argv)
    finally:
        if sys.stdout is not saved:
            sys.stdout.close()
        sys.stdout = saved
    assert trainer.state.model.world_feat.mode == "gather" and trainer.state.step == 2
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "Train epoch 1 done" in log and log.count("Test: loss") == 2 and "clip" not in log
    assert (tmp_path / "run" / "checkpoints" / "2" / "state.pt").is_file()
