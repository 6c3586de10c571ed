"""The VGG-11 backbone, the rematerialised ResNet trunk and the two losses
the port lacked, against the JAX package (remat against the port without
it), on the CPU:

- ``vgg11_features`` against ``VGG11Features`` (f32, and a bf16 input that
  promotes the trunk to f32 in both); the torchvision loader against JAX's;
- the VGG-11 model at inference (f32, bf16), one training step against
  JAX's f64 run (the stride-16 per-view head maps resized to the targets'
  grid on both sides, ``train/trainer.py::supervised_loss``), the weights
  bridge both ways and a reference checkpoint through both loaders;
- ``remat_backbone``: one train step with remat equals one without, bit for
  bit (loss, every gradient, every parameter and BatchNorm statistic after
  the step), each block running twice in training and once at inference;
- ``reg_ce_loss`` and ``gaussian_smoothed_mse_loss`` and their gradients.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu import losses as jax_losses
from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.interop import detect_reference_config
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.models.vgg import VGG11Features, load_torchvision_vgg11_state_dict as jax_load_vgg11
from mvdetr_tpu.models.world_feat import modules as jax_modules
from mvdetr_tpu_torch import losses
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.resnet import BasicBlock
from mvdetr_tpu_torch.models.vgg import TORCHVISION_CONV_IDX, vgg11_features
from mvdetr_tpu_torch.train import create_train_state, train_step
from _torch_port import few_torch_threads, synthetic_train_batch  # noqa: F401
from _torch_port_jax import (
    BF16_TOL, F32_TOL, assert_round_trip, assert_step_matches, checkpoint_forward_pair, close, forward_pair,
    init_variables, jax_loss_and_grads, port_step,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=2, img_shape=(96, 160), worldgrid_shape=(32, 64))
KW = dict(world_reduce=2, img_reduce=12, bottleneck_dim=32, arch="vgg11")


def _torchvision_vgg11(seed=0):
    """A torchvision ``vgg11`` state dict's layout (features and classifier), seeded."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for t, cout in zip(TORCHVISION_CONV_IDX, (64, 128, 256, 256, 512, 512, 512, 512)):
        sd[f"features.{t}.weight"] = (rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))).astype(
            np.float32)
        sd[f"features.{t}.bias"] = rng.normal(0, 0.05, cout).astype(np.float32)
        cin = cout
    sd["classifier.0.weight"] = np.zeros((8, 8), np.float32)
    return sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg11_trunk_matches_flax_from_torchvision_weights(dtype):
    """Both trunks from the same torchvision weights (each through its own
    loader) on a [2, 3, 64, 96] input: output stride 16, 512 channels; a
    bf16 input gives an f32 trunk in both."""
    sd = _torchvision_vgg11()
    trunk = vgg11_features()
    with torch.no_grad():
        for t in TORCHVISION_CONV_IDX:
            trunk[t].weight.copy_(torch.from_numpy(sd[f"features.{t}.weight"]))
            trunk[t].bias.copy_(torch.from_numpy(sd[f"features.{t}.bias"]))
    assert isinstance(trunk[17], torch.nn.Identity) and len(trunk) == 20
    x = np.random.default_rng(1).standard_normal((2, 64, 96, 3)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    ref = VGG11Features().apply(jax_load_vgg11(sd), jnp.asarray(x, jd), train=False)
    with torch.no_grad():
        ours = trunk(torch.from_numpy(x).to(td).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(ours.shape) == (2, 4, 6, 512) and ours.dtype == torch.float32 and ref.dtype == jnp.float32
    close(ours, ref, F32_TOL)


def test_backbone_ckpt_loads_vgg11_weights():
    """``create_train_state(backbone_variables=)`` of a VGG-11 model reads a
    torchvision vgg11 state dict (the classifier left out), as JAX's loader."""
    sd = _torchvision_vgg11(seed=2)
    model = MVDeTr.from_rig(make_synthetic_rig(**RIG), device="cpu", **KW)
    create_train_state(model, total_steps=10, backbone_variables={k: torch.from_numpy(v) for k, v in sd.items()})
    ref = jax_load_vgg11(sd)["params"]
    for i, t in enumerate(TORCHVISION_CONV_IDX):
        np.testing.assert_array_equal(model.state_dict()[f"base.{t}.weight"].numpy(),
                                      np.transpose(ref[f"conv{i}"]["kernel"], (3, 2, 0, 1)))
        np.testing.assert_array_equal(model.state_dict()[f"base.{t}.bias"].numpy(), ref[f"conv{i}"]["bias"])


@pytest.fixture(scope="module")
def gate():
    """The VGG-11 model with the flagship fusion (windowed shadow
    transformer), its encoder dropout at 0 on both sides."""
    batch = synthetic_train_batch(make_synthetic_rig(**RIG), 2, 2, 12, seed=5)
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), encoder_dropout=0.0, device="cpu", **KW)
    var = init_variables(port, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_modules, "DeformTransWorldFeat",
                   functools.partial(jax_modules.DeformTransWorldFeat, dropout=0.0))
        ref = jax_loss_and_grads(JaxMVDeTr.from_rig(jax_make_rig(**RIG), **KW), var, batch)
    return dict(var=var, batch=batch, ref=ref, ours=port_step(port, var, batch))


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
    assert tuple(ours[2].shape) == (4, 4, 6, 1)  # per-view heads at stride 16
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        close(o, r, BF16_TOL if td is not None else F32_TOL)


def test_train_step_matches_jax(gate):
    assert_step_matches(gate["ours"], gate["ref"])


def test_bridge_round_trip_and_checkpoint(gate, tmp_path):
    sd = from_jax_variables(gate["var"], device="cpu")
    assert sorted({int(k.split(".")[1]) for k in sd if k.startswith("base.")}) == list(TORCHVISION_CONV_IDX)
    assert_round_trip(sd, gate["var"])
    assert detect_reference_config({k: v.numpy() for k, v in sd.items()})["arch"] == "vgg11"
    path = str(tmp_path / "MultiviewDetector.pth")
    torch.save(dict(sd), path)
    fresh = MVDeTr.from_rig(make_synthetic_rig(**RIG), device="cpu", seed=9, warp_convention="kornia", **KW)
    jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), warp_convention="kornia", **KW)
    ours, ref, cfg = checkpoint_forward_pair(path, jm, fresh, gate["batch"]["imgs"], gate["batch"]["affine_mats"])
    assert cfg["arch"] == "vgg11" and cfg["world_feat_arch"] == "deform_trans"
    for o, r in zip(ours, ref):
        close(o, r, F32_TOL)


@pytest.mark.parametrize("world_feat_arch", ["deform_trans", "conv"])
def test_remat_step_equals_the_step_without_bitwise(world_feat_arch):
    """Rematerialised blocks rerun their forward in the backward with the
    running statistics frozen: the step, and the state after it, are the
    same bits as without remat. Encoder dropout on, from the same generator."""
    rig = make_synthetic_rig(num_cam=2, img_shape=(48, 96), worldgrid_shape=(32, 64))
    batch = synthetic_train_batch(rig, 2, 2, 12, seed=3)
    runs = []
    for remat in (False, True):
        model = MVDeTr.from_rig(rig, world_reduce=2, world_feat_arch=world_feat_arch, remat_backbone=remat,
                                device="cpu", seed=4)
        blocks = [m for m in model.modules() if isinstance(m, BasicBlock)]
        assert len(blocks) == 8 and all(b.remat == remat for b in blocks)
        calls = []
        for b in blocks:
            b.register_forward_pre_hook(lambda *_: calls.append(1))
            b._block = (lambda f: lambda x: (calls.append(2), f(x))[1])(b._block)
        state = create_train_state(model, total_steps=10)
        _, aux = train_step(state, batch, torch.Generator().manual_seed(0), device="cpu")
        assert calls.count(2) == (16 if remat else 8) and calls.count(1) == 8
        runs.append((aux, {n: p.grad.clone() for n, p in model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()}))
        calls.clear()
        with torch.no_grad():
            model.eval()(torch.from_numpy(batch["imgs"]), torch.from_numpy(batch["affine_mats"]))
        assert calls.count(2) == 8  # inference: no checkpoint
    (aux0, g0, s0), (aux1, g1, s1) = runs
    assert {k: float(v) for k, v in aux0.items()} == {k: float(v) for k, v in aux1.items()}
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert int(s1["base.4.0.bn1.num_batches_tracked"]) == 1


def test_reg_ce_loss_matches_jax():
    rng = np.random.default_rng(0)
    out = rng.standard_normal((2, 6, 8, 5)).astype(np.float32)
    idx = rng.integers(0, 48, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.7).astype(np.float32)
    target = rng.integers(0, 5, (2, 7)).astype(np.int32)
    ref, vjp = jax.vjp(lambda o: jax_losses.reg_ce_loss(o, jnp.asarray(mask), jnp.asarray(idx), jnp.asarray(target)),
                       jnp.asarray(out))
    t = torch.from_numpy(out).requires_grad_()
    ours = losses.reg_ce_loss(t, torch.from_numpy(mask), torch.from_numpy(idx), torch.from_numpy(target))
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-6)
    close(t.grad, vjp(jnp.ones(()))[0], 1e-6)


@pytest.mark.parametrize("target_hw,kernel_size", [((12, 16), 10), ((24, 32), 8), ((36, 48), 6)])
def test_gaussian_smoothed_mse_loss_matches_jax(target_hw, kernel_size):
    """At the output's size and at 2x and 3x (the target max-pooled down)."""
    rng = np.random.default_rng(1)
    out = rng.standard_normal((2, 12, 16, 1)).astype(np.float32)
    target = (rng.random((2,) + target_hw + (1,)) ** 8).astype(np.float32)
    ref, vjp = jax.vjp(lambda o: jax_losses.gaussian_smoothed_mse_loss(o, jnp.asarray(target), kernel_size),
                       jnp.asarray(out))
    t = torch.from_numpy(out).requires_grad_()
    ours = losses.gaussian_smoothed_mse_loss(t, torch.from_numpy(target), kernel_size)
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-5)
    close(t.grad, vjp(jnp.ones(()))[0], 1e-6)


@pytest.mark.parametrize("stride,padding,dilation,bias", [(1, 1, 1, True), (2, 1, 1, False), (1, 2, 2, True)])
def test_deterministic_backward_conv_equals_autograd(stride, padding, dilation, bias):
    """VGG's convs take their backward through ``convolution_backward`` with
    cuDNN held to deterministic algorithms: on the CPU the same bits as
    autograd's own backward of ``F.conv2d``."""
    from mvdetr_tpu_torch.models.layers import Conv2d

    rng = np.random.default_rng(5)
    conv = Conv2d(5, 7, 3, stride, padding, dilation, bias=bias, deterministic_backward=True)
    x = torch.from_numpy(rng.standard_normal((2, 5, 11, 13)).astype(np.float32)).requires_grad_()
    out = conv(x)
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
    params = [x, conv.weight] + ([conv.bias] if bias else [])
    ours = torch.autograd.grad(out, params, g)
    ref_out = torch.nn.functional.conv2d(x, conv.weight, conv.bias, stride, padding, dilation)
    assert torch.equal(out, ref_out)
    for a, b in zip(ours, torch.autograd.grad(ref_out, params, g)):
        assert torch.equal(a, b)
