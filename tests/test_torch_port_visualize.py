"""Visualisation (``mvdetr_tpu_torch/utils/visualize.py`` and
``Trainer.dump_figures``) against the JAX package's, on the CPU:

- the host functions (``denormalize_image``, ``heatmap_overlay``,
  ``warp_image_np``, ``grid_overlay``, ``shadow_points``,
  ``shadow_backprojected``, ``detection_video_frames``) on the same numpy
  inputs and the same rig: bitwise equal, or within 1e-6 where noted;
- ``capture_attention`` at windowed 4 points, warped 8 points and gather
  mode, and ``capture_forward_stages``, on the 3-camera rig of
  ``tests/test_visualize.py:70-108`` (bottleneck 32), the port's model from
  JAX's variables (seeded, perturbed): the structures that test asserts,
  and the arrays within 1e-4 of their scale (``F32_TOL``, the port's f32
  model tolerance: the whole trunk and encoder lie before them);
- ``Trainer.test(visualize_dir=)`` writes JAX's figure files (``world.jpg``,
  ``cam1_foot.jpg``, ``stage_*.jpg``, ``shadow_points.jpg``); without
  matplotlib it writes none and logs one line saying which and why.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.utils import visualize as jax_viz
from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.train import Trainer, create_train_state
from mvdetr_tpu_torch.utils import visualize as viz

from _torch_port import few_torch_threads, synthetic_train_batch  # noqa: F401
from _torch_port_jax import F32_TOL, close, init_variables

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, IMG_REDUCE, NECK = 2, 12, 32
# (n_points, attn_mode) of each attention mode's model
MODES = {"windowed": (4, "auto"), "warped": (8, "auto"), "gather": (4, "gather")}


def test_host_functions_match_jax():
    rng = np.random.default_rng(0)
    rig, jrig = make_synthetic_rig(**RIG), jax_make_rig(**RIG)
    img = rng.uniform(0, 1, (12, 16, 3))
    mat = np.array([[1.1, 0.05, 1.5], [-0.03, 0.9, -0.7], [1e-3, -2e-3, 1.0]])
    assert np.array_equal(viz.warp_image_np(img, mat, (10, 14)), jax_viz.warp_image_np(img, mat, (10, 14)))
    normed = rng.standard_normal((5, 7, 3))
    assert np.array_equal(viz.denormalize_image(normed), jax_viz.denormalize_image(normed))
    image = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    hm = rng.uniform(0, 1, (6, 8))
    assert np.array_equal(viz.heatmap_overlay(hm, image), jax_viz.heatmap_overlay(hm, image))
    images = [rng.integers(0, 256, (48, 80, 3)).astype(np.uint8) for _ in range(3)]
    for ours, ref in zip(viz.grid_overlay(rig, images, WORLD_REDUCE), jax_viz.grid_overlay(jrig, images, WORLD_REDUCE)):
        assert ours.dtype == np.uint8 and np.array_equal(ours, ref)
    loc, wgt = rng.uniform(0, 1, (10, 2, 3, 4, 2)), rng.uniform(0, 1, (10, 2, 3, 4))
    ours, ref = viz.shadow_points(rig, loc, wgt, None, WORLD_REDUCE), jax_viz.shadow_points(jrig, loc, wgt, None,
                                                                                             WORLD_REDUCE)
    assert set(ours) == set(ref) == {0, 1, 2}
    for cam in ref:
        assert all(np.array_equal(a, b) for a, b in zip(ours[cam], ref[cam]))
    (bev, cams), (jbev, jcams) = (f(r, loc, wgt, 4, world_reduce=WORLD_REDUCE) for f, r in
                                  ((viz.shadow_backprojected, rig), (jax_viz.shadow_backprojected, jrig)))
    for cam in range(3):  # the same numpy, through each package's copy of the rig's homographies: 1e-6
        for a, b in zip(bev[cam] + cams[cam], jbev[cam] + jcams[cam]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    det = np.array([[0, 30.0, 16.0], [0, 50.0, 20.0], [1, 10.0, 40.0]])
    frames = {0: [rng.integers(0, 256, (48, 96, 3)).astype(np.uint8) for _ in range(3)],
              1: [np.zeros((48, 96, 3), np.uint8) for _ in range(3)]}
    ours, ref = viz.detection_video_frames(rig, det, frames), jax_viz.detection_video_frames(jrig, det, frames)
    assert ours.keys() == ref.keys()
    assert all(np.array_equal(a, b) for f in ref for a, b in zip(ours[f], ref[f]))


class _JaxState:
    """What the JAX package's captures read of a train state."""

    def __init__(self, model, variables):
        self.apply_fn = model.apply
        self.params = variables["params"]
        self.batch_stats = variables["batch_stats"]


@pytest.fixture(scope="module")
def models():
    """Per attention mode: the JAX model, its variables (the port's seeded
    init, perturbed) and the port's model loaded from them, and a batch."""
    rig, jrig = make_synthetic_rig(**RIG), jax_make_rig(**RIG)
    batch = synthetic_train_batch(rig, 1, WORLD_REDUCE, IMG_REDUCE, seed=3)
    out = {}
    for mode, (points, attn_mode) in MODES.items():
        kw = dict(world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, bottleneck_dim=NECK, n_points=points,
                  attn_mode=attn_mode)
        port = MVDeTr.from_rig(rig, device="cpu", seed=1, **kw)
        assert port.world_feat.mode == mode
        variables = init_variables(port, seed=2)
        port.load_state_dict(from_jax_variables(variables, device="cpu"))
        out[mode] = (JaxMVDeTr.from_rig(jrig, **kw), variables, port)
    return batch, out


@pytest.mark.parametrize("mode", list(MODES))
def test_capture_attention_matches_jax(models, mode):
    batch, by_mode = models
    jax_model, variables, port = by_mode[mode]
    jbatch = {k: jnp.asarray(batch[k]) for k in ("imgs", "affine_mats")}
    _, jlayers = jax_viz.capture_attention(_JaxState(jax_model, variables), jbatch)
    _, layers = viz.capture_attention(port, batch)
    n, p = RIG["num_cam"], MODES[mode][0]
    hs, ws = (v // WORLD_REDUCE // 2 for v in RIG["worldgrid_shape"])
    assert len(layers) == len(jlayers) == 3  # one per encoder layer
    for ours, ref in zip(layers, jlayers):
        assert ours.keys() == ref.keys() == {"sampling_locations", "attention_weights"}
        assert ours["sampling_locations"].shape == (1, n * hs * ws, 8, n, p, 2)
        assert ours["attention_weights"].shape == (1, n * hs * ws, 8, n, p)
        np.testing.assert_allclose(ours["attention_weights"].sum((-1, -2)), 1.0, atol=1e-4)
        for key in ours:
            close(torch.from_numpy(ours[key]), ref[key], F32_TOL)
    bev, cams = viz.shadow_backprojected(make_synthetic_rig(**RIG), layers[0]["sampling_locations"][0],
                                         layers[0]["attention_weights"][0], query_index=hs * ws // 2,
                                         world_reduce=WORLD_REDUCE)
    assert set(cams) == set(range(n)) and all(np.isfinite(cams[c][0]).all() for c in cams)
    assert cams[0][0].shape == (8 * p, 2)


def test_capture_forward_stages_match_jax(models):
    batch, by_mode = models
    jax_model, variables, port = by_mode["windowed"]
    jbatch = {k: jnp.asarray(batch[k]) for k in ("imgs", "affine_mats")}
    _, jstages = jax_viz.capture_forward_stages(_JaxState(jax_model, variables), jbatch)
    _, stages = viz.capture_forward_stages(port, batch)
    hs, ws = (v // WORLD_REDUCE for v in RIG["worldgrid_shape"])
    assert stages.keys() == jstages.keys() == {"img_featmap", "world_inputs", "world_feature"}
    assert stages["img_featmap"].shape[0] == 3  # B*N per-view maps
    assert stages["world_inputs"].shape == (1, 3, hs, ws, NECK)
    assert stages["world_feature"].shape == (1, hs, ws, NECK)
    for key in stages:
        close(torch.from_numpy(stages[key]), jstages[key], F32_TOL)


def _trainer(lines):
    rig = make_synthetic_rig(num_cam=2, img_shape=(48, 96), worldgrid_shape=(32, 64))
    scene = SyntheticScene(rig, num_frame=4, num_person=4, seed=0)
    kw = dict(world_reduce=2, img_reduce=12, world_kernel_size=10, img_kernel_size=10, seed=0)
    model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, device="cpu", seed=0)
    state = create_train_state(model, lr=1e-3, total_steps=4)
    return Trainer(state, FrameDataset(scene, train=True, **kw), FrameDataset(scene, train=False, **kw),
                   cls_thres=0.3, logger=lines.append)


def test_trainer_test_writes_the_figures(tmp_path):
    lines = []
    _trainer(lines).test(batch_size=1, visualize_dir=str(tmp_path / "visualize"))
    assert sorted(p.name for p in (tmp_path / "visualize").iterdir()) == sorted(Trainer.FIGURES)
    assert all((tmp_path / "visualize" / name).stat().st_size > 0 for name in Trainer.FIGURES)
    assert any(line.startswith("Test: loss") for line in lines)


def test_trainer_without_matplotlib_skips_the_figures_with_one_line(tmp_path, monkeypatch):
    lines = []
    trainer = _trainer(lines)
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(__import__("sys").modules, name, None)  # import raises ImportError
    trainer.test(batch_size=1, visualize_dir=str(tmp_path / "visualize"))
    skipped = [line for line in lines if "--visualize skipped" in line]
    assert len(skipped) == 1 and "matplotlib is not installed" in skipped[0]
    assert all(name in skipped[0] for name in Trainer.FIGURES)
    assert not (tmp_path / "visualize").exists()
