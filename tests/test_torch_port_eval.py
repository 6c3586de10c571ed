"""The evaluation path of the port against the JAX package:

- ``clear_metrics``: exactly equal to the JAX package's on seeded random
  detection and ground-truth rows and on the cases of ``tests/test_eval.py``
  that need no reference checkout (both are the same numpy + scipy code);
- ``ctdet_decode``: within 1e-6 of the JAX one, ties included (the port's
  stable ``top_k`` orders equal scores by index, as ``lax.top_k`` does);
- ``Trainer.test``'s host logic: given the same eval outputs, the same
  detection rows in ``test.txt`` and exactly the same loss, MODA, MODP,
  precision and recall as the JAX ``Trainer.test`` (the ``cls_thres`` cut on
  the kept top-K, the cap warning, the ij -> xy swap, ``%d`` rows, the floor
  before CLEAR);
- ``Trainer.test`` end to end, from JAX variables carried across, in f32, on
  the same numpy batches: candidates within 1e-4 of their scale, keep masks
  (scores within 1e-5), keep masks and metrics equal. The heatmap head's
  weights are scaled so its top-K scores lie apart, and the test asserts the
  margins it relies on on the JAX side first (neighbouring scores and the
  threshold 5e-5 apart, five times the score tolerance; no candidate pair
  within 1e-3 of the NMS radius; no kept coordinate within 1e-3 of an
  integer, where the floor before CLEAR would flip), so it cannot pass on a
  tie.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import mvdetr_tpu.train.trainer as jax_trainer_mod
import mvdetr_tpu_torch.train.trainer as trainer_mod
from mvdetr_tpu.data import FrameDataset as JaxFrameDataset
from mvdetr_tpu.data import SyntheticScene as JaxScene
from mvdetr_tpu.evaluation import clear_metrics as jax_clear
from mvdetr_tpu.geometry import make_synthetic_rig as jax_rig
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.ops import decode as jax_decode
from mvdetr_tpu.train import Trainer as JaxTrainer
from mvdetr_tpu.train.state import TrainState as JaxTrainState
from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
from mvdetr_tpu_torch.evaluation import clear_metrics
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.ops import ctdet_decode
from mvdetr_tpu_torch.train import Trainer, create_train_state, load_full_variables

from _torch_port import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

# ------------------------------------------------------------------ CLEAR

EVAL_CASES = {  # tests/test_eval.py
    "perfect": ([[0, 10, 10], [0, 50, 50], [1, 30, 30]], [[0, 10, 10], [0, 50, 50], [1, 30, 30]]),
    "near-miss-and-fp": ([[0, 10, 10], [0, 100, 100]], [[0, 14, 13], [0, 500, 500]]),
    "no-detections": ([[0, 10, 10]], np.zeros((0, 3))),
    "moda-clamped": ([[0, 10, 10]], [[0, 500, 500], [0, 600, 600], [0, 700, 700]]),
    "frames-without-detections": ([[0, 10, 10], [1, 20, 20]], [[0, 10, 10]]),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_clear_metrics_cases_equal_jax(case):
    gt, det = (np.asarray(x, dtype=float) for x in EVAL_CASES[case])
    assert clear_metrics(gt, det) == jax_clear(gt, det)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_clear_metrics_random_rows_equal_jax(seed):
    r = np.random.default_rng(seed)
    gt_rows, det_rows = [], []
    for t in range(8):
        pts = r.uniform(0, 200, (r.integers(1, 9), 2))
        gt_rows += [[t, *p] for p in pts]
        det_rows += [[t, *(p + r.normal(0, 9, 2))] for p in pts if r.random() < 0.8]
        det_rows += [[t, *r.uniform(0, 200, 2)] for _ in range(r.integers(0, 3))]
    gt, det = np.floor(np.asarray(gt_rows)), np.floor(np.asarray(det_rows))
    ours = clear_metrics(gt, det)
    assert ours == jax_clear(gt, det)
    assert 0 < ours[2] < 100 and 0 < ours[3] < 100


# ----------------------------------------------------------------- decode

@pytest.mark.parametrize("with_wh", [False, True])
def test_ctdet_decode_matches_jax_with_ties(with_wh):
    r = np.random.default_rng(4)
    heat = np.round(r.normal(0, 2, (2, 9, 13, 1)) * 2) / 2  # quantised logits: many ties, many plateaus
    heat[0, 2:4, 5:7] = 3.0  # a 2x2 plateau of equal maxima: all four are peaks
    off = r.uniform(0, 1, (2, 9, 13, 2))
    wh = r.uniform(1, 9, (2, 9, 13, 2)) if with_wh else None
    args = [heat.astype(np.float32), off.astype(np.float32), None if wh is None else wh.astype(np.float32)]
    ours = ctdet_decode(*(None if a is None else torch.from_numpy(a) for a in args), top_k=40).numpy()
    ref = np.asarray(jax_decode.ctdet_decode(*(None if a is None else jnp.asarray(a) for a in args), top_k=40))
    assert ours.shape == ref.shape == (2, 40, 5 if with_wh else 3)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    scores = ours[..., -1]
    assert (np.diff(scores, axis=1) <= 0).all() and (np.diff(scores, axis=1) == 0).any()  # ties present


def test_ctdet_decode_without_offsets():
    heat = np.random.default_rng(5).normal(0, 1, (1, 6, 7, 1)).astype(np.float32)
    ours = ctdet_decode(torch.from_numpy(heat), top_k=10).numpy()
    ref = np.asarray(jax_decode.ctdet_decode(jnp.asarray(heat), top_k=10))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


# ------------------------------------------------------- Trainer.test host

IJ_RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96), indexing="ij", worldcoord_unit=0.01,
              origin_offset=(-60.0, -120.0))
DS = dict(world_reduce=2, img_reduce=12, top_k=16, world_kernel_size=4, img_kernel_size=4, seed=3)


def _splits(rig_kw, num_frame):
    jax_scene = JaxScene(jax_rig(**rig_kw), num_frame=num_frame, num_person=6, seed=5)
    scene = SyntheticScene(make_synthetic_rig(**rig_kw), num_frame=num_frame, num_person=6, seed=5)
    return ((JaxFrameDataset(jax_scene, train=True, **DS), JaxFrameDataset(jax_scene, train=False, **DS)),
            (FrameDataset(scene, train=True, **DS), FrameDataset(scene, train=False, **DS)))


def _canned_outputs(frames, gt, k=24):
    """Eval outputs per frame: candidates near the frame's ground truth (in
    the model's grid order, so the ij swap puts them back), false positives,
    a random keep mask; frame 37's candidates all clear the threshold (a cap
    hit; NMS keeps only those near its ground truth), frame 39's none."""
    xys, keep = [], []
    for f in frames:
        r = np.random.default_rng(int(f))
        rows = gt[gt[:, 0] == f][:, [2, 1]]  # native (x, y) -> grid (x, y) on an ij rig
        pts = np.concatenate([rows + r.normal(0, 6, rows.shape), r.uniform(0, 96, (k, 2))])[:k]
        scores = r.uniform(0.0, 0.5, k)  # false positives: mostly below the threshold
        scores[: len(rows)] = r.uniform(0.4, 1.0, len(rows))
        if f == 37:
            scores = r.uniform(0.6, 1.0, k)
        if f == 39:
            scores = r.uniform(0.0, 0.4, k)
        xys.append(np.concatenate([pts, scores[:, None]], 1).astype(np.float32))
        keep.append((r.random(k) < 0.85) & ((np.arange(k) < len(rows)) | (f != 37)))
    return np.stack(xys), np.stack(keep)


def test_trainer_test_host_logic_matches_jax(monkeypatch, tmp_path):
    (jax_train, jax_test), (train, test) = _splits(IJ_RIG, num_frame=40)
    assert test.frames == jax_test.frames == [36, 37, 38, 39]
    gt = test.gt_array()
    np.testing.assert_array_equal(gt, jax_test.gt_array())
    losses = {36: 1.5, 37: 0.25, 38: 2.0, 39: 0.125}

    def jax_fake(state, batch, **kw):
        frames = np.asarray(batch["frame"])
        xys, keep = _canned_outputs(frames, gt)
        return {"loss": jnp.float32(np.mean([losses[int(f)] for f in frames]))}, jnp.asarray(xys), jnp.asarray(keep)

    def fake(model, batch, **kw):
        frames = np.asarray(batch["frame"])
        xys, keep = _canned_outputs(frames, gt)
        return ({"loss": torch.tensor(np.mean([losses[int(f)] for f in frames]), dtype=torch.float32)},
                torch.from_numpy(xys), torch.from_numpy(keep))

    monkeypatch.setattr(jax_trainer_mod, "eval_step", jax_fake)
    monkeypatch.setattr(trainer_mod, "eval_step", fake)
    logs, jax_logs = [], []
    state = types.SimpleNamespace(model=torch.nn.Linear(1, 1))
    ours = Trainer(state, train, test, cls_thres=0.45, logger=logs.append, nms_top_k=24).test(
        batch_size=3, res_fpath=str(tmp_path / "ours.txt"))
    ref = JaxTrainer(None, jax_train, jax_test, cls_thres=0.45, logger=jax_logs.append, nms_top_k=24).test(
        batch_size=3, res_fpath=str(tmp_path / "ref.txt"))
    assert ours == ref
    assert 0 < ours[1] < 100 and ours[3] < 100
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "ref.txt").read_text()
    assert any("top-K cap (24) saturated on 1 frame(s)" in line for line in logs)
    assert [line.split(", t ")[0] for line in logs] == [line.split(", t ")[0] for line in jax_logs]


# -------------------------------------------------- Trainer.test end to end

XY_RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
K, NMS_DIST = 6, 20.0
SCORE_ATOL, SCORE_MARGIN, MARGIN = 1e-5, 5e-5, 1e-3


@pytest.fixture(scope="module")
def carried_over():
    """JAX variables (the heatmap head's kernel scaled by 5, so its logits
    spread), the JAX splits and the port's splits of one scene, and the JAX
    model's dense test-split scores."""
    (jax_train, jax_test), (train, test) = _splits(XY_RIG, num_frame=30)
    batch = next(jax_test.batches(batch_size=3))
    jm = JaxMVDeTr.from_rig(jax_rig(**XY_RIG), world_reduce=2, img_reduce=12)
    var = jax.jit(lambda k: jm.init({"params": k}, jnp.asarray(batch["imgs"][:1]),
                                    jnp.asarray(batch["affine_mats"][:1]), train=False))(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, var["params"])
    params["world_heatmap"]["proj"]["kernel"] = params["world_heatmap"]["proj"]["kernel"] * 5.0
    variables = {"params": params, "batch_stats": jax.tree.map(np.asarray, var["batch_stats"])}
    (heat, off), _ = jm.apply(variables, jnp.asarray(batch["imgs"]), jnp.asarray(batch["affine_mats"]), train=False,
                              mutable=["diagnostics"])[0]
    return dict(variables=variables, jm=jm, jax=(jax_train, jax_test), port=(train, test), batch=batch,
                dense=np.asarray(jax.nn.sigmoid(heat)).reshape(heat.shape[0], -1))


def test_trainer_test_end_to_end_matches_jax(carried_over, monkeypatch, tmp_path):
    c = carried_over
    jax_train, jax_test = c["jax"]
    train, test = c["port"]
    assert len(test) == 3
    port_batch = next(test.batches(batch_size=3))
    for key in ("imgs", "affine_mats", "frame"):  # the same numpy batch on both sides
        np.testing.assert_array_equal(port_batch[key], c["batch"][key])

    # margins on the JAX side: the top K+1 scores of each frame set apart, and a threshold between two of them
    top = -np.sort(-c["dense"], axis=1)[:, : K + 1]
    assert np.diff(-top, axis=1).min() > SCORE_MARGIN, np.diff(-top, axis=1).min()
    cand = np.sort(top[:, :K].ravel())
    gaps = np.diff(cand)
    i = len(cand) // 2 + int(np.argmax(gaps[len(cand) // 2 : -2]))
    cls_thres = float(cand[i] + cand[i + 1]) / 2
    assert np.abs(cand - cls_thres).min() > SCORE_MARGIN

    recorded = {"jax": [], "port": []}

    def record(fn, key):
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            recorded[key].append(out)
            return out
        return wrapper

    monkeypatch.setattr(jax_trainer_mod, "eval_step", record(jax_trainer_mod.eval_step, "jax"))
    monkeypatch.setattr(trainer_mod, "eval_step", record(trainer_mod.eval_step, "port"))
    jm = c["jm"]
    jax_state = JaxTrainState.create(apply_fn=jm.apply, params=c["variables"]["params"], tx=optax.identity(),
                                     batch_stats=c["variables"]["batch_stats"])
    ref = JaxTrainer(jax_state, jax_train, jax_test, cls_thres=cls_thres, nms_top_k=K, logger=lambda *a: None).test(
        batch_size=3, res_fpath=str(tmp_path / "ref.txt"))
    model = MVDeTr.from_rig(make_synthetic_rig(**XY_RIG), world_reduce=2, img_reduce=12, device="cpu")
    state = load_full_variables(create_train_state(model), c["variables"])
    ours = Trainer(state, train, test, cls_thres=cls_thres, nms_top_k=K, logger=lambda *a: None).test(
        batch_size=3, res_fpath=str(tmp_path / "ours.txt"))

    (jaux, jxys, jkeep), = recorded["jax"]
    (aux, xys, keep), = recorded["port"]
    jxys, jkeep = np.asarray(jxys), np.asarray(jkeep)
    # the NMS radius and the floor before CLEAR: no candidate pair at the radius, no kept coordinate at an integer
    d = np.linalg.norm(jxys[:, :, None, :2] - jxys[:, None, :, :2], axis=-1)
    assert np.abs(d - NMS_DIST).min() > MARGIN
    kept = jxys[jkeep & (jxys[..., 2] > cls_thres)][:, :2]
    assert len(kept) > 0 and np.abs(kept - np.round(kept)).min() > MARGIN

    np.testing.assert_allclose(xys.numpy()[..., :2], jxys[..., :2], atol=1e-4 * max(1.0, np.abs(jxys).max()), rtol=0)
    np.testing.assert_allclose(xys.numpy()[..., 2], jxys[..., 2], atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5)
    assert ours[1:] == ref[1:]
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "ref.txt").read_text()
    assert 0 < keep.sum() < keep.numel()
