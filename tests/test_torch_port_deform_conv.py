"""The deformable convolution and the ``deform_conv`` BEV fusion against the
JAX package, on the CPU:

- ``deform_conv2d``'s forward and its four gradients (input, offsets,
  weight, bias) against ``jax.vjp`` of ``mvdetr_tpu.ops.deform_conv``, at
  random, integer and off-map offsets; two backwards bitwise equal; the
  input's gradient is one ``warp_scatter_accumulate`` call over all taps
  (the plain B3 on the CPU), and a grouped call equals its groups' calls;
- ``DeformConvWorldFeat`` alone (f32 with gradients; a bf16 input promotes
  the module to f32, as in JAX);
- the whole model at inference (f32, bf16), one training step against
  JAX's f64 run, the weights bridge both ways (with the offset channels'
  (dy, dx) <-> (dx, dy) swap), and a reference checkpoint through both
  loaders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.interop import convert_reference_state_dict, detect_reference_config
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.models.world_feat import modules as jax_modules
from mvdetr_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.world_feat import DeformConvWorldFeat, build_world_feat
from mvdetr_tpu_torch.ops import deform_conv as dc
from _torch_port import few_torch_threads, synthetic_train_batch  # noqa: F401
from _torch_port_jax import (
    BF16_TOL, F32_TOL, assert_grads_match, assert_round_trip, assert_step_matches, checkpoint_forward_pair, close, flat,
    forward_pair, init_variables, jax_loss_and_grads, port_step,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=2, img_shape=(96, 160), worldgrid_shape=(32, 64))
KW = dict(world_reduce=2, img_reduce=12, bottleneck_dim=32, world_feat_arch="deform_conv")
BEV = (16, 32)


def _op_inputs(offsets, seed=0, b=2, h=7, w=9, cin=5, cout=6):
    rng = np.random.default_rng(seed)
    if offsets == "random":
        off = rng.normal(0.0, 1.5, (b, h, w, 9, 2))
    elif offsets == "integer":  # every tap on a pixel centre: floor() at its discontinuity
        off = rng.integers(-2, 3, (b, h, w, 9, 2))
    else:  # "off-map": most taps past the border, some partly inside
        off = rng.uniform(-2.0 * w, 2.0 * w, (b, h, w, 9, 2))
    return (rng.standard_normal((b, h, w, cin)).astype(np.float32), off.astype(np.float32),
            rng.standard_normal((3, 3, cin, cout)).astype(np.float32), rng.standard_normal(cout).astype(np.float32),
            rng.standard_normal((b, h, w, cout)).astype(np.float32))


@pytest.mark.parametrize("offsets", ["random", "integer", "off-map"])
def test_deform_conv2d_and_its_gradients_match_jax(offsets):
    x, off, wt, bias, g = _op_inputs(offsets)
    ref, vjp = jax.vjp(jax.jit(jax_deform_conv2d), *map(jnp.asarray, (x, off, wt, bias)))
    refs = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, off, wt, bias)]
    out = dc.deform_conv2d(*ts)
    close(out, ref, 1e-5)
    out.backward(torch.from_numpy(g))
    for name, t, r in zip(("x", "offsets", "weight", "bias"), ts, refs):
        assert t.grad.shape == t.shape, name
        close(t.grad, r, 1e-5)
    if offsets == "integer":  # JAX's autodiff: the slope of x - floor(x) is 1 at an integer too
        assert float(ts[1].grad.abs().max()) > 0


def test_backward_repeats_bitwise_and_runs_one_b3_call(monkeypatch):
    """Two backwards of the same forward are bitwise equal; the input's
    gradient is one ``warp_scatter_accumulate`` call with all K*H*W taps of
    every map, which on the CPU runs the plain B3 (``bilinear_scatter_matmul``)."""
    x, off, wt, bias, g = _op_inputs("random", seed=1)
    calls = []
    real = dc.warp_scatter_accumulate

    def spy(gs, sx, sy, h, w):
        calls.append((tuple(gs.shape), tuple(sx.shape), h, w, gs.device.type))
        return real(gs, sx, sy, h, w)

    monkeypatch.setattr(dc, "warp_scatter_accumulate", spy)
    grads = []
    for _ in range(2):
        ts = [torch.from_numpy(a).requires_grad_() for a in (x, off, wt, bias)]
        dc.deform_conv2d(*ts).backward(torch.from_numpy(g))
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert calls == [((2, 9 * 7 * 9, 5), (2, 9 * 7 * 9), 7, 9, "cpu")] * 2


def test_grouped_call_equals_its_groups():
    """Three groups (cameras) with their own weights in one call: each
    group's output and gradients equal a call of its own, bitwise."""
    ins = [_op_inputs("random", seed=s) for s in (2, 3, 4)]
    stacked = [torch.from_numpy(np.stack([i[k] for i in ins])).requires_grad_() for k in range(4)]
    out = dc.deform_conv2d_grouped(*stacked)
    out.backward(torch.from_numpy(np.stack([i[4] for i in ins])))
    for gi, (x, off, wt, bias, g) in enumerate(ins):
        ts = [torch.from_numpy(a).requires_grad_() for a in (x, off, wt, bias)]
        single = dc.deform_conv2d(*ts)
        single.backward(torch.from_numpy(g))
        assert torch.equal(out[gi], single)
        for s, t in zip(stacked, ts):
            np.testing.assert_allclose(s.grad[gi].numpy(), t.grad.numpy(), rtol=0, atol=1e-6)


def test_deform_conv2d_rejects_mismatched_shapes():
    x, off, wt, bias, _ = _op_inputs("random")
    with pytest.raises(ValueError, match="do not fit"):
        dc.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off[..., :4, :]), torch.from_numpy(wt))


@pytest.fixture(scope="module")
def gate():
    batch = synthetic_train_batch(make_synthetic_rig(**RIG), 2, 2, 12, seed=5)
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), device="cpu", **KW)
    var = init_variables(port, seed=1)
    ref = jax_loss_and_grads(JaxMVDeTr.from_rig(jax_make_rig(**RIG), **KW), var, batch)
    return dict(var=var, batch=batch, ref=ref, ours=port_step(port, var, batch))


def test_module_matches_jax_with_gradients(gate):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 2) + BEV + (32,)).astype(np.float32)
    g = rng.standard_normal((2,) + BEV + (32,)).astype(np.float32)
    sd = from_jax_variables(gate["var"], device="cpu")
    mod = build_world_feat("deform_conv", 2, BEV, base_dim=32)
    assert isinstance(mod, DeformConvWorldFeat)
    mod.load_state_dict({k[len("world_feat."):]: v for k, v in sd.items() if k.startswith("world_feat.")})
    jmod = jax_modules.build_world_feat("deform_conv", 2, BEV, base_dim=32)
    jout, vjp = jax.vjp(jax.jit(lambda p, xx: jmod.apply(p, xx, train=False)),
                        {"params": gate["var"]["params"]["world_feat"]}, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    out, clips = mod(tx)
    assert clips == []
    close(out, jout, F32_TOL)
    out.backward(torch.from_numpy(g))
    assert np.linalg.norm(tx.grad.numpy() - np.asarray(jgx)) <= 1e-2 * np.linalg.norm(np.asarray(jgx))
    grads = {k: v.numpy() for k, v in sd.items()}
    grads.update({f"world_feat.{n}": p.grad.numpy() for n, p in mod.named_parameters()})
    assert_grads_match(flat(convert_reference_state_dict(grads)["params"]["world_feat"]), flat(jgp["params"]))

    # a bf16 input: x + the f32 embedding promotes the whole module to f32, in JAX and here
    with torch.no_grad():
        ours, _ = mod(torch.from_numpy(x).to(torch.bfloat16))
    ref = jmod.apply({"params": gate["var"]["params"]["world_feat"]}, jnp.asarray(x, jnp.bfloat16), train=False)
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    close(ours, ref, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_forward_matches_jax(gate, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    td = torch.bfloat16 if dtype == "bfloat16" else None
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 2, 64, 106, 3), dtype=np.uint8)
    aff = np.tile(np.eye(3, dtype=np.float32), (2, 2, 1, 1))
    aff[0, 1] = [[1.1, 0.05, -6.0], [-0.03, 0.95, 4.0], [0, 0, 1]]
    jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), compute_dtype=jd, **KW)
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), compute_dtype=td, device="cpu", **KW)
    ours, ref = forward_pair(jm, port, gate["var"], imgs, aff)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        close(o, r, BF16_TOL if td is not None else F32_TOL)


def test_train_step_matches_jax(gate):
    assert_step_matches(gate["ours"], gate["ref"])


def test_bridge_round_trip_and_offset_layout(gate):
    """The port keeps the reference's (dy, dx) offset channels: channel 2k of
    ``deform_pos.{cam}`` is the JAX kernel's channel 2k+1 and back."""
    sd = from_jax_variables(gate["var"], device="cpu")
    params = gate["var"]["params"]["world_feat"]
    assert sorted({k.split(".")[1] for k in sd if k.startswith("world_feat.")}) == [
        "deform_conv", "deform_pos", "merge_linear", "world_feat"]
    jk = np.asarray(params["deform_pos1"]["kernel"])[0, 0]  # [C, 18] as (dx, dy) per tap
    ours = sd["world_feat.deform_pos.1.weight"].numpy()[:, :, 0, 0]  # [18, C] as (dy, dx)
    np.testing.assert_array_equal(ours[0::2], jk[:, 1::2].T)
    np.testing.assert_array_equal(ours[1::2], jk[:, 0::2].T)
    assert sd["world_feat.deform_conv.0.weight"].shape == (32, 32, 3, 3)
    assert_round_trip(sd, gate["var"])
    cfg = detect_reference_config({k: v.numpy() for k, v in sd.items()})
    assert cfg["world_feat_arch"] == "deform_conv" and cfg["num_cam"] == 2


def test_reference_checkpoint_loads_as_in_jax(gate, tmp_path):
    path = str(tmp_path / "MultiviewDetector.pth")
    torch.save({"state_dict": dict(from_jax_variables(gate["var"], device="cpu"))}, path)
    fresh = MVDeTr.from_rig(make_synthetic_rig(**RIG), device="cpu", seed=9, warp_convention="kornia", **KW)
    jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), warp_convention="kornia", **KW)
    ours, ref, cfg = checkpoint_forward_pair(path, jm, fresh, gate["batch"]["imgs"], gate["batch"]["affine_mats"])
    assert cfg["world_feat_arch"] == "deform_conv" and cfg["num_cam"] == 2
    for o, r in zip(ours, ref):
        close(o, r, F32_TOL)
