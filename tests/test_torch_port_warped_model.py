"""The 8-point shadow configuration (``n_points=8``, ``warped`` attention) end
to end against the JAX package, on the 3-camera rig of
``test_torch_port_model.py``:

- the weights bridge: ``convert_reference_state_dict(port.state_dict())``
  gives back the JAX variables bit for bit, and ``detect_reference_config``
  reads ``n_points == 8`` from the offset projection's width;
- the whole forward at inference, f32 and bf16 (the bounds of
  ``test_torch_port_model.py``: 1e-4 and 4e-2 of the output scale);
- one ``train_step`` from the same carried-over weights and batch, in f32,
  without dropout (the bounds of ``test_torch_port_train.py``: the loss to
  1e-5 relative, every gradient leaf to 1e-2 in relative L2), with seeded
  noise on the offset and attention-weight kernels so that no offset is an
  integer (there JAX's XLA vjp and the port's TPU-kernel convention differ
  by design); and ``eval_step``'s loss and detections;
- one tiny CPU epoch of ``python -m mvdetr_tpu_torch.cli --n_points 8``.
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
from mvdetr_tpu.train import eval_step as jax_eval_step
from mvdetr_tpu.train import train_step as jax_train_step
from mvdetr_tpu.train.trainer import supervised_loss as jax_supervised_loss
from mvdetr_tpu_torch import cli
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.train import create_train_state, eval_step, train_step
from _torch_port import few_torch_threads, synthetic_train_batch  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, IMG_REDUCE = 2, 12
F32_TOL, BF16_TOL = 1e-4, 4e-2
LR, TOTAL_STEPS = 5e-4, 100
LOSS_KEYS = ("loss", "w_hm", "w_off", "img_hm", "img_off", "img_wh")
K = 8


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
    """The JAX model at n_points 8 (dropout 0), perturbed; its gradients, one
    train step and one eval step; the port's from the same variables."""
    jax_rig, rig = jax_make_rig(**RIG), make_synthetic_rig(**RIG)
    batch = synthetic_train_batch(rig, 2, WORLD_REDUCE, IMG_REDUCE, seed=5)
    jbatch = jax.tree.map(jnp.asarray, batch)
    no_dropout = functools.partial(jax_world_feat_modules.DeformTransWorldFeat, dropout=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_world_feat_modules, "DeformTransWorldFeat", no_dropout)
        jm = JaxMVDeTr.from_rig(jax_rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, n_points=8)
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
        jeval, jxys, jkeep = jax_eval_step(state, jbatch, world_reduce=WORLD_REDUCE, num_candidates=K)

    port = MVDeTr.from_rig(rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, n_points=8, encoder_dropout=0.0,
                           device="cpu")
    port.load_state_dict(from_jax_variables(var, device="cpu"))
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    peval, xys, keep = eval_step(port, batch, world_reduce=WORLD_REDUCE, num_candidates=K, device="cpu")
    pstate = create_train_state(port, lr=LR, total_steps=TOTAL_STEPS)
    pstate, paux = train_step(pstate, batch, torch.Generator().manual_seed(0), device="cpu")
    grads = {k: v.numpy().copy() for k, v in sd.items()}
    grads.update({n: p.grad.detach().numpy().copy() for n, p in port.named_parameters()})
    return dict(var=var, jm=jm, state_dict=sd, port_mode=port.world_feat.mode,
                jax_aux={k: float(v) for k, v in jaux.items()}, port_aux={k: float(v) for k, v in paux.items()},
                jax_grads=_flat(jgrads), port_grads=_flat(convert_reference_state_dict(grads)["params"]),
                jax_eval={k: float(v) for k, v in jeval.items()}, port_eval={k: float(v) for k, v in peval.items()},
                jax_det=(np.asarray(jxys), np.asarray(jkeep)), port_det=(xys.numpy(), keep.numpy()), batch=batch)


def test_bridge_round_trip_and_detected_config(gate):
    """The port's names are the reference checkpoint's at n_points 8 (the
    shadow coordinates are a non-persistent buffer); the checkpoint's
    offset projection is 8 heads x 3 cameras x 8 points x 2 wide."""
    sd = gate["state_dict"]
    assert not any("shadow" in k for k in sd)
    assert sd["world_feat.encoder.layers.0.self_attn.sampling_offsets.weight"].shape == (8 * 3 * 8 * 2, 128)
    back = convert_reference_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(gate["var"]))
    assert flat_back.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_back[k]), np.asarray(v), err_msg=jax.tree_util.keystr(k))
    cfg = detect_reference_config({k: v.numpy() for k, v in sd.items()})
    assert cfg["world_feat_arch"] == "deform_trans" and cfg["num_cam"] == 3 and cfg["n_points"] == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_forward_matches_jax(gate, dtype):
    """uint8 frames with one non-identity augmentation affine, through the
    whole n_points-8 model at inference; warped mode resolved by ``auto``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    td = torch.bfloat16 if dtype == "bfloat16" else None
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 3, 64, 106, 3), dtype=np.uint8)
    aff = np.tile(np.eye(3, dtype=np.float32), (2, 3, 1, 1))
    aff[0, 1] = [[1.1, 0.05, -6.0], [-0.03, 0.95, 4.0], [0, 0, 1]]
    jm = JaxMVDeTr.from_rig(jax_make_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, n_points=8,
                            compute_dtype=jd)
    apply = jax.jit(lambda v, i, a: jm.apply(v, i, a, train=False, mutable=["diagnostics"]))
    ref, diag = apply(gate["var"], jnp.asarray(imgs), jnp.asarray(aff))
    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, n_points=8,
                           compute_dtype=td, device="cpu")
    port.load_state_dict(gate["state_dict"])
    assert port.world_feat.mode == "warped"
    with torch.no_grad():
        ours, clips = port(torch.from_numpy(imgs), torch.from_numpy(aff))
    tol = BF16_TOL if td is not None else F32_TOL
    for o, r in zip((*ours[0], *ours[1]), jax.tree.leaves(ref)):
        assert o.dtype == torch.float32
        _close(o, r, tol)
    np.testing.assert_allclose([float(c) for c in clips], np.asarray(jax.tree.leaves(diag)), atol=1e-2)


def test_train_step_loss_matches_jax(gate):
    assert gate["port_mode"] == "warped"
    for k in (*LOSS_KEYS, "offset_clip_fraction"):
        np.testing.assert_allclose(gate["port_aux"][k], gate["jax_aux"][k], rtol=1e-5,
                                   atol=1e-7 if k != "loss" else 0, err_msg=k)
    assert 0 < gate["jax_aux"]["offset_clip_fraction"] < 1


def test_train_step_gradients_match_jax(gate):
    """Every gradient leaf to 1e-2 in relative L2, through the shadow warp's
    backward (the warp adjoint) and the windowed backward over 24 pseudo-levels."""
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


def test_eval_step_loss_and_detections_match_jax(gate):
    """The loss terms to 1e-5 relative, and the detections: at the init the
    heatmap is nearly flat, so neighbouring top-K scores lie closer (down to
    ~5e-6) than the port and JAX agree, and a near-tie may swap two
    candidates. Each of the port's top K-1 candidates is therefore matched
    to a JAX top-K candidate within 1e-4 of the coordinates' scale and 1e-5
    in score (the K-th may trade places with JAX's K+1-th), and the
    candidates NMS keeps match one to one."""
    for k in (*LOSS_KEYS, "offset_clip_fraction"):
        np.testing.assert_allclose(gate["port_eval"][k], gate["jax_eval"][k], rtol=1e-5, atol=1e-7, err_msg=k)
    (jxys, jkeep), (xys, keep) = gate["jax_det"], gate["port_det"]
    assert xys.shape == jxys.shape == (2, K, 3)
    coord_tol = 1e-4 * max(1.0, np.abs(jxys[..., :2]).max())

    def match(cand, pool):
        d = np.abs(pool[:, :2] - cand[:2]).max(-1)
        j = int(np.argmin(d))
        return d[j] <= coord_tol and abs(pool[j, 2] - cand[2]) <= 1e-5

    for f in range(2):
        assert all(match(c, jxys[f]) for c in xys[f, : K - 1]), f
        assert keep[f].sum() == jkeep[f].sum() > 0
        assert all(match(c, jxys[f][jkeep[f]]) for c in xys[f][keep[f]]), f


def test_cli_epoch_with_eight_points(tmp_path):
    """One tiny CPU epoch of ``python -m mvdetr_tpu_torch.cli --n_points 8``:
    warped attention, a checkpoint, a test pass with the eval
    offset_clip_fraction logged."""
    argv = ["-d", "synthetic", "--device", "cpu", "--synthetic_cams", "2", "--synthetic_frames", "6",
            "--synthetic_img", "48", "96", "--synthetic_grid", "32", "64", "--world_reduce", "2",
            "--cls_thres", "0.3", "--batch_size", "2", "-j", "2", "--epochs", "1", "--n_points", "8",
            "--logdir", str(tmp_path / "run")]
    saved = sys.stdout
    try:
        trainer = cli.main(argv)
    finally:
        if sys.stdout is not saved:
            sys.stdout.close()
        sys.stdout = saved
    model = trainer.state.model
    assert model.world_feat.mode == "warped" and trainer.state.step == 2
    assert model.world_feat.encoder.layers[0].self_attn.shadow_xy.shape == (2, 2, 8 * 16 * 8)
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "Train epoch 1 done" in log and "Eval offset_clip_fraction" in log and log.count("Test: loss") == 2
    assert (tmp_path / "run" / "checkpoints" / "2" / "state.pt").is_file()


def test_trainer_warns_on_clamped_offsets_in_warped_mode():
    """The Trainer's train and eval offset_clip_fraction warnings fire in
    warped mode as in windowed mode (`mvdetr_tpu/train/trainer.py:253-260,
    374-381`): with every offset bias past the radius, the clip fraction
    is 1 and both warnings are logged."""
    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
    from mvdetr_tpu_torch.train import Trainer

    rig = make_synthetic_rig(num_cam=2, img_shape=(48, 96), worldgrid_shape=(32, 64))
    scene = SyntheticScene(rig, num_frame=4, num_person=3, seed=0)
    kw = dict(world_reduce=2, img_reduce=12, world_kernel_size=10, img_kernel_size=10)
    model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, n_points=8, device="cpu", seed=0)
    assert model.world_feat.mode == "warped"
    with torch.no_grad():
        for layer in model.world_feat.encoder.layers:
            layer.self_attn.sampling_offsets.bias.fill_(10.0)
    lines = []
    trainer = Trainer(create_train_state(model, lr=1e-4, total_steps=4), FrameDataset(scene, train=True, **kw),
                      FrameDataset(scene, train=False, **kw), logger=lines.append)
    trainer.train_epoch(1, batch_size=2)
    trainer.test(batch_size=1)
    log = "\n".join(lines)
    assert "WARNING: offset_clip_fraction 1.000 > 0.05" in log
    assert "Eval offset_clip_fraction 1.0000" in log and "WARNING: >5% of attention offsets are clamped" in log
