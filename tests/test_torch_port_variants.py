"""The ``conv`` and ``trans`` BEV fusions and the dense transformer encoder
against the JAX package, on the CPU, at the sizes of ``tests/test_models.py``
(2 cameras, base_dim 32, a 16x32 BEV; 96x160 frames, where the trunk's f32
gradients are well enough conditioned for the 1e-2 gate):

- ``TransformerEncoder`` against flax's (``MultiHeadDotProductAttention``
  post-norm layers), in f32 and from bf16 inputs (JAX promotes the encoder
  to f32, and so does the port);
- ``ConvWorldFeat`` and ``TransformerWorldFeat`` alone: the forward in f32
  (1e-4 of scale) with the input's and parameters' gradients (1e-2 relative
  L2), and in bf16 (4e-2);
- the whole model at inference, f32 and bf16, and one training step (loss
  terms to 1e-5, every gradient leaf within 1e-2 relative L2, against JAX's
  f64 run: see ``_torch_port_jax.jax_loss_and_grads``), at dropout 0;
- the weights bridge both ways (``from_jax_variables``, then
  ``convert_reference_state_dict`` gives the JAX variables back bit for bit)
  and ``detect_reference_config`` on the port's names; a reference
  checkpoint through both loaders;
- the shadow transformer at MultiviewX's shape (6 cameras, xy indexing).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.interop import convert_reference_state_dict, detect_reference_config
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.models.transformer import TransformerEncoder as JaxTransformerEncoder
from mvdetr_tpu.models.world_feat import modules as jax_modules
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.transformer import TransformerEncoder
from mvdetr_tpu_torch.models.world_feat import ConvWorldFeat, TransformerWorldFeat, build_world_feat
from _torch_port import few_torch_threads, synthetic_train_batch  # noqa: F401
from _torch_port_jax import (
    BF16_TOL, F32_TOL, assert_grads_match, assert_round_trip, assert_step_matches, checkpoint_forward_pair, close, flat,
    forward_pair, init_variables, jax_loss_and_grads, port_step,
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=2, img_shape=(96, 160), worldgrid_shape=(32, 64))
KW = dict(world_reduce=2, img_reduce=12, bottleneck_dim=32)
BEV = (16, 32)


@pytest.fixture(scope="module")
def gates():
    """Per variant: the perturbed JAX variables, the batch, the JAX step's
    loss and gradients (dropout patched to 0) and the port's."""
    out = {}
    batch = synthetic_train_batch(make_synthetic_rig(**RIG), 2, KW["world_reduce"], KW["img_reduce"], seed=5)
    for arch in ("conv", "trans"):
        jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), world_feat_arch=arch, **KW)
        port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_feat_arch=arch, encoder_dropout=0.0, device="cpu",
                               **KW)
        var = init_variables(port, seed=1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_modules, "TransformerWorldFeat",
                       functools.partial(jax_modules.TransformerWorldFeat, dropout=0.0))
            ref = jax_loss_and_grads(jm, var, batch)
        out[arch] = dict(var=var, batch=batch, ref=ref, ours=port_step(port, var, batch))
    return out


def _module_params(var, arch):
    """The port module and its JAX twin's parameters, from the whole model's variables."""
    sd = from_jax_variables(var, device="cpu")
    mod = build_world_feat(arch, 2, BEV, base_dim=32, dropout=0.0)
    mod.load_state_dict({k[len("world_feat."):]: v for k, v in sd.items() if k.startswith("world_feat.")})
    return mod, {"params": var["params"]["world_feat"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_encoder_matches_flax(gates, dtype):
    """The trans model's encoder on [2, 32, 32] tokens with the sine
    embedding; bf16 tokens and embedding promote to an f32 encoder."""
    rng = np.random.default_rng(3)
    src = rng.standard_normal((2, 32, 32)).astype(np.float32)
    pos = rng.standard_normal((1, 32, 32)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = {"params": gates["trans"]["var"]["params"]["world_feat"]["encoder"]}
    ref = JaxTransformerEncoder(3, 32, 8, 512, 0.0).apply(params, jnp.asarray(src, jd), jnp.asarray(pos, jd),
                                                            train=False)
    enc = TransformerEncoder(3, 32, 8, 512, 0.0)
    sd = from_jax_variables(gates["trans"]["var"], device="cpu")
    enc.load_state_dict({k[len("world_feat.encoder."):]: v for k, v in sd.items()
                         if k.startswith("world_feat.encoder.")})
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with torch.no_grad():
        ours = enc(torch.from_numpy(src).to(td), torch.from_numpy(pos).to(td))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    close(ours, ref, F32_TOL)


@pytest.mark.parametrize("arch", ["conv", "trans"])
def test_module_matches_jax_with_gradients(gates, arch):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 2) + BEV + (32,)).astype(np.float32)
    g = rng.standard_normal((2,) + BEV + (32,)).astype(np.float32)
    mod, jparams = _module_params(gates[arch]["var"], arch)
    assert isinstance(mod, {"conv": ConvWorldFeat, "trans": TransformerWorldFeat}[arch])
    jmod = jax_modules.build_world_feat(arch, 2, BEV, base_dim=32)
    jout, vjp = jax.vjp(jax.jit(lambda p, xx: jmod.apply(p, xx, train=False)), jparams, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    out, clips = mod(tx)
    assert clips == []
    close(out, jout, F32_TOL)
    out.backward(torch.from_numpy(g))
    assert np.linalg.norm(tx.grad.numpy() - np.asarray(jgx)) <= 1e-2 * np.linalg.norm(np.asarray(jgx))
    assert_grads_match(flat(_jax_grads_of(mod, gates[arch]["var"])), flat(jgp["params"]))


def _jax_grads_of(mod, var):
    """The module's parameter gradients in the JAX tree's layout, through the
    JAX converter of the whole model's state dict."""
    sd = {k: v.numpy() for k, v in from_jax_variables(var, device="cpu").items()}
    sd.update({f"world_feat.{n}": p.grad.numpy() for n, p in mod.named_parameters()})
    return convert_reference_state_dict(sd)["params"]["world_feat"]


@pytest.mark.parametrize("arch", ["conv", "trans"])
def test_module_bf16_matches_jax(gates, arch):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 2) + BEV + (32,)).astype(np.float32)
    sd = from_jax_variables(gates[arch]["var"], device="cpu")
    mod = build_world_feat(arch, 2, BEV, base_dim=32, dropout=0.0, dtype=torch.bfloat16)
    mod.load_state_dict({k[len("world_feat."):]: v for k, v in sd.items() if k.startswith("world_feat.")})
    jmod = jax_modules.build_world_feat(arch, 2, BEV, base_dim=32, dtype=jnp.bfloat16)
    ref = jmod.apply({"params": gates[arch]["var"]["params"]["world_feat"]}, jnp.asarray(x, jnp.bfloat16),
                     train=False)
    with torch.no_grad():
        ours, _ = mod(torch.from_numpy(x).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    close(ours, np.asarray(ref, np.float32), BF16_TOL)


@pytest.mark.parametrize("arch", ["conv", "trans"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_forward_matches_jax(gates, arch, dtype):
    """uint8 frames with one non-identity augmentation affine, at inference."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    td = torch.bfloat16 if dtype == "bfloat16" else None
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 2, 64, 106, 3), dtype=np.uint8)
    aff = np.tile(np.eye(3, dtype=np.float32), (2, 2, 1, 1))
    aff[0, 1] = [[1.1, 0.05, -6.0], [-0.03, 0.95, 4.0], [0, 0, 1]]
    jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), world_feat_arch=arch, compute_dtype=jd, **KW)
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_feat_arch=arch, compute_dtype=td, device="cpu", **KW)
    ours, ref = forward_pair(jm, port, gates[arch]["var"], imgs, aff)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        close(o, r, BF16_TOL if td is not None else F32_TOL)


@pytest.mark.parametrize("arch", ["conv", "trans"])
def test_train_step_matches_jax(gates, arch):
    assert_step_matches(gates[arch]["ours"], gates[arch]["ref"])


@pytest.mark.parametrize("arch", ["conv", "trans"])
def test_bridge_round_trip_and_detected_config(gates, arch):
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_feat_arch=arch, device="cpu", **KW)
    port.load_state_dict(from_jax_variables(gates[arch]["var"], device="cpu"))
    sd = port.state_dict()
    wf = sorted({k.split(".")[1] for k in sd if k.startswith("world_feat.")})
    assert wf == {"conv": ["downsample", "upsample", "world_feat"], "trans": ["downsample", "encoder", "upsample"]}[arch]
    if arch == "trans":
        assert sd["world_feat.encoder.layers.2.self_attn.in_proj_weight"].shape == (3 * 32, 32)
    else:
        assert sd["world_feat.world_feat.0.weight"].shape == (32, 2 * 32 + 2, 3, 3)
    assert_round_trip(sd, gates[arch]["var"])
    assert detect_reference_config({k: v.numpy() for k, v in sd.items()})["world_feat_arch"] == arch


def test_shadow_transformer_at_multiviewx_shape():
    """The flagship fusion on a MultiviewX-like rig: 6 cameras, xy indexing,
    a non-square grid; the whole forward at inference in f32."""
    rig_kw = dict(num_cam=6, img_shape=(48, 96), worldgrid_shape=(40, 64), indexing="xy", name="MultiviewXSmall")
    jax_rig = jax_make_rig(**rig_kw)
    assert jax_rig.indexing == "xy" and jax_rig.num_cam == 6
    batch = synthetic_train_batch(make_synthetic_rig(**rig_kw), 1, 2, 12, seed=2)
    jm = JaxMVDeTr.from_rig(jax_rig, **KW)
    port = MVDeTr.from_rig(make_synthetic_rig(**rig_kw), device="cpu", **KW)
    assert port.world_feat.mode == "windowed" and port.world_feat.lvl_embedding.shape == (6, 32)
    var = init_variables(port, seed=4)
    ours, ref = forward_pair(jm, port, var, batch["imgs"], batch["affine_mats"])
    for o, r in zip(ours, ref):
        close(o, r, F32_TOL)


@pytest.mark.parametrize("arch", ["conv", "trans"])
def test_reference_checkpoint_loads_as_in_jax(gates, arch, tmp_path):
    """A ``MultiviewDetector.pth`` of the variant, as a reference run saves it
    (``{"state_dict": {"module." + k: v}}``), through both loaders: the
    detected configuration and the forward at inference within 1e-4."""
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_feat_arch=arch, device="cpu", **KW)
    port.load_state_dict(from_jax_variables(gates[arch]["var"], device="cpu"))
    path = str(tmp_path / "MultiviewDetector.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in port.state_dict().items()}}, path)
    fresh = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_feat_arch=arch, device="cpu", seed=9,
                            warp_convention="kornia", **KW)
    jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), world_feat_arch=arch, warp_convention="kornia", **KW)
    batch = gates[arch]["batch"]
    ours, ref, cfg = checkpoint_forward_pair(path, jm, fresh, batch["imgs"], batch["affine_mats"])
    assert cfg == {"arch": "resnet18", "bottleneck_dim": 32, "outfeat_dim": 0, "world_feat_arch": arch}
    for o, r in zip(ours, ref):
        close(o, r, F32_TOL)
