"""The ``aio`` BEV fusion (merge the views, then a single-level ``gather``
encoder) against the JAX package, on the 3-camera rig of
``test_torch_port_model.py``, in the CPU:

- the weights bridge both ways: ``from_jax_variables`` learns the
  ``merge`` / ``encoder`` / ``output`` tree, and
  ``convert_reference_state_dict(port.state_dict())`` gives back the JAX
  variables bit for bit; ``detect_reference_config`` reads ``aio``;
- ``DeformTransWorldFeatAIO`` alone, forward and gradients;
- the whole forward at inference, f32 (1e-4 of scale) and bf16 (4e-2);
- one ``train_step`` from the same weights and batch, in f32, without
  dropout (loss to 1e-5 relative, every gradient leaf within 1e-2 in
  relative L2);
- one tiny CPU epoch of ``python -m mvdetr_tpu_torch.cli --world_feat aio``.
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.interop import convert_reference_state_dict, detect_reference_config
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.models.world_feat import modules as jax_world_feat_modules
from mvdetr_tpu.train import create_train_state as jax_create_train_state
from mvdetr_tpu.train import train_step as jax_train_step
from mvdetr_tpu.train.trainer import supervised_loss as jax_supervised_loss
from mvdetr_tpu_torch import cli
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.world_feat import DeformTransWorldFeatAIO
from mvdetr_tpu_torch.train import create_train_state, train_step
from _torch_port import few_torch_threads, synthetic_train_batch  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, IMG_REDUCE = 2, 12
F32_TOL, BF16_TOL = 1e-4, 4e-2
LR, TOTAL_STEPS = 5e-4, 100
LOSS_KEYS = ("loss", "w_hm", "w_off", "img_hm", "img_off", "img_wh")


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


def _close(ours, ref, rel):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


@pytest.fixture(scope="module")
def gate():
    """The JAX aio model (dropout 0), perturbed; its gradients and one train
    step; the port's from the same variables."""
    jax_rig, rig = jax_make_rig(**RIG), make_synthetic_rig(**RIG)
    batch = synthetic_train_batch(rig, 2, WORLD_REDUCE, IMG_REDUCE, seed=5)
    jbatch = jax.tree.map(jnp.asarray, batch)
    no_dropout = functools.partial(jax_world_feat_modules.DeformTransWorldFeatAIO, dropout=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_world_feat_modules, "DeformTransWorldFeatAIO", no_dropout)
        jm = JaxMVDeTr.from_rig(jax_rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, world_feat_arch="aio")
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

    port = MVDeTr.from_rig(rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, world_feat_arch="aio",
                           encoder_dropout=0.0, device="cpu")
    port.load_state_dict(from_jax_variables(var, device="cpu"))
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    pstate = create_train_state(port, lr=LR, total_steps=TOTAL_STEPS)
    pstate, paux = train_step(pstate, batch, torch.Generator().manual_seed(0), device="cpu")
    grads = {k: v.numpy().copy() for k, v in sd.items()}
    grads.update({n: p.grad.detach().numpy().copy() for n, p in port.named_parameters()})
    return dict(var=var, state_dict=sd, port=port,
                jax_aux={k: float(v) for k, v in jaux.items()}, port_aux={k: float(v) for k, v in paux.items()},
                jax_grads=_flat(jgrads), port_grads=_flat(convert_reference_state_dict(grads)["params"]))


def test_bridge_round_trip_and_detected_config(gate):
    """The port's names are the reference aio checkpoint's; the JAX
    converter reads them back into the JAX variables bit for bit."""
    sd = gate["state_dict"]
    wf = sorted({k.split(".")[1] for k in sd if k.startswith("world_feat.")})
    assert wf == ["encoder", "merge", "output"]
    assert sd["world_feat.merge.0.weight"].shape == (128, 3 * 128, 1, 1)
    assert sd["world_feat.encoder.layers.2.self_attn.sampling_offsets.weight"].shape == (8 * 1 * 4 * 2, 128)
    back = convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(gate["var"]))
    assert flat_back.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_back[k]), np.asarray(v), err_msg=jax.tree_util.keystr(k))
    assert detect_reference_config({k: v.numpy() for k, v in sd.items()})["world_feat_arch"] == "aio"


def test_aio_module_matches_jax(gate):
    """``DeformTransWorldFeatAIO`` alone at the rig's BEV grid (24x48, one
    level, 1152 queries), f32: the forward within 1e-4 of scale and the
    input's and parameters' gradients within 1e-2 relative L2, with the
    radial init unscaled (gather mode) on both sides."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 24, 48, 128)).astype(np.float32)
    g = rng.standard_normal((2, 24, 48, 128)).astype(np.float32)
    jmod = jax_world_feat_modules.DeformTransWorldFeatAIO(3, (24, 48), dropout=0.0)
    wf = {"params": gate["var"]["params"]["world_feat"]}
    jout, vjp = jax.vjp(jax.jit(lambda p_, xx: jmod.apply(p_, xx, train=False)), wf, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    mod = DeformTransWorldFeatAIO(3, (24, 48), dropout=0.0)
    assert mod.mode == "gather"
    mod.load_state_dict({k[len("world_feat."):]: v for k, v in gate["state_dict"].items()
                         if k.startswith("world_feat.")})
    tx = torch.from_numpy(x).requires_grad_()
    out, clips = mod(tx)
    assert clips == []
    _close(out, jout, F32_TOL)
    out.backward(torch.from_numpy(g))
    rel = np.linalg.norm(tx.grad.numpy() - np.asarray(jgx)) / np.linalg.norm(np.asarray(jgx))
    assert rel <= 1e-2
    ours = _flat(convert_reference_state_dict(
        {**{k: v.numpy() for k, v in gate["state_dict"].items()},
         **{f"world_feat.{n}": p.grad.numpy() for n, p in mod.named_parameters()}})["params"]["world_feat"])
    for k, ref in _flat(jgp["params"]).items():
        assert np.linalg.norm(ours[k] - ref) / np.linalg.norm(ref) <= 1e-2, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_forward_matches_jax(gate, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    td = torch.bfloat16 if dtype == "bfloat16" else None
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 3, 64, 106, 3), dtype=np.uint8)
    aff = np.tile(np.eye(3, dtype=np.float32), (2, 3, 1, 1))
    aff[0, 1] = [[1.1, 0.05, -6.0], [-0.03, 0.95, 4.0], [0, 0, 1]]
    jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                            world_feat_arch="aio", compute_dtype=jd)
    ref = jax.jit(lambda v, i, a: jm.apply(v, i, a, train=False))(gate["var"], jnp.asarray(imgs), jnp.asarray(aff))
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE,
                           world_feat_arch="aio", compute_dtype=td, device="cpu")
    port.load_state_dict(gate["state_dict"])
    with torch.no_grad():
        ours, clips = port(torch.from_numpy(imgs), torch.from_numpy(aff))
    assert clips == []
    tol = BF16_TOL if td is not None else F32_TOL
    for o, r in zip((*ours[0], *ours[1]), jax.tree.leaves(ref)):
        assert o.dtype == torch.float32
        _close(o, r, tol)


def test_train_step_matches_jax(gate):
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


def test_cli_epoch_with_aio(tmp_path):
    """One tiny CPU epoch of ``python -m mvdetr_tpu_torch.cli --world_feat aio``."""
    argv = ["-d", "synthetic", "--device", "cpu", "--synthetic_cams", "2", "--synthetic_frames", "6",
            "--synthetic_img", "48", "96", "--synthetic_grid", "32", "64", "--world_reduce", "2",
            "--cls_thres", "0.3", "--batch_size", "2", "-j", "2", "--epochs", "1", "--world_feat", "aio",
            "--logdir", str(tmp_path / "run")]
    saved = sys.stdout
    try:
        trainer = cli.main(argv)
    finally:
        if sys.stdout is not saved:
            sys.stdout.close()
        sys.stdout = saved
    model = trainer.state.model
    assert isinstance(model.world_feat, DeformTransWorldFeatAIO) and trainer.state.step == 2
    assert model.world_feat.encoder.layers[0].self_attn.reference_points.shape == (16 * 32, 1, 1, 1, 2)
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "Train epoch 1 done" in log and log.count("Test: loss") == 2 and "clip" not in log
