"""The port's accuracy and day-one scripts (``mvdetr_tpu_torch/scripts/``),
twins of the repo's ``scripts/hard_benchmark.py``, ``stress_ab.py``,
``tune_convergence.py``, ``rehearse_realscale.py`` and ``full_scale_run.py``
(``rehearse_day_one.py``'s is in ``test_torch_port_day_one.py``):

- the hard benchmark's and the stress A/B's rig, scene and datasets against
  the JAX package's construction of the same arguments (rebuilt here: the
  JAX scripts set up a compilation cache when imported): the same rig, the
  same annotations, and the same batch bytes -- the test split, and the train
  split without augmentation; with augmentation every key but ``imgs`` is
  identical and ``imgs`` hold ``test_torch_port_data``'s bound (the JAX
  package warps with cv2, the port with its native warp);
- each twin's ``main`` once on the CPU (``--device cpu``) at a tiny size (a
  smaller rig or scene patched in where the flags do not reach): it prints
  its result line with a finite MODA (or, for the pipeline rehearsal, its
  rates).
"""

import functools
import itertools
import math
import re

import numpy as np
import pytest

from mvdetr_tpu.data import FrameDataset as JaxFrameDataset
from mvdetr_tpu.data import SyntheticScene as JaxScene
from mvdetr_tpu.geometry import make_synthetic_rig as jax_rig
from mvdetr_tpu_torch.scripts import full_scale_run, hard_benchmark, rehearse_realscale, stress_ab, tune_convergence

from _torch_port import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TINY_RIG = dict(num_cam=2, img_shape=(96, 160), worldgrid_shape=(64, 128))


def _jax_hard_benchmark_data(seed=5, num_person=24, kernel=4.0, augmentation=True):
    """``scripts/hard_benchmark.py::run``'s rig, scene and datasets."""
    rig = jax_rig(num_cam=6, img_shape=(270, 480), worldgrid_shape=(256, 512), camera_height_m=3.5,
                  camera_margin_m=2.0, name="HardBench")
    scene = JaxScene(rig, num_frame=60, num_person=num_person, seed=seed)
    kw = dict(world_reduce=4, img_reduce=12, top_k=48, world_kernel_size=kernel, img_kernel_size=kernel)
    return rig, scene, JaxFrameDataset(scene, train=True, augmentation=augmentation, **kw), JaxFrameDataset(
        scene, train=False, **kw)


def _jax_stress_data(seed=3, augmentation=True):
    """``scripts/stress_ab.py::run``'s rig, scene and datasets."""
    rig = jax_rig(num_cam=4, img_shape=(96, 160), worldgrid_shape=(48, 96), camera_height_m=2.0, camera_margin_m=1.0,
                  name="Stress")
    scene = JaxScene(rig, num_frame=40, num_person=20, seed=seed)
    kw = dict(world_reduce=2, img_reduce=12, top_k=32, world_kernel_size=4, img_kernel_size=4)
    return rig, scene, JaxFrameDataset(scene, train=True, augmentation=augmentation, **kw), JaxFrameDataset(
        scene, train=False, **kw)


def _flat(batch):
    for key, value in batch.items():
        if isinstance(value, dict):
            yield from ((f"{key}.{k}", v) for k, v in value.items())
        else:
            yield key, value


def _same_batches(ours, theirs, augmented, n=2):
    for b, jb in zip(itertools.islice(ours.batches(2), n), itertools.islice(theirs.batches(2), n)):
        for (key, a), (_, r) in zip(_flat(b), _flat(jb)):
            assert a.dtype == r.dtype and a.shape == r.shape, key
            if key == "imgs" and augmented:
                assert np.quantile(np.abs(a.astype(int) - r.astype(int)), 0.99) <= 2, key
            else:
                assert a.tobytes() == r.tobytes(), key


@pytest.mark.parametrize("script", ["hard_benchmark", "stress_ab"])
@pytest.mark.parametrize("augmentation", [True, False])
def test_script_data_is_the_jax_scripts(script, augmentation):
    if script == "hard_benchmark":
        rig, scene, train_set, test_set = hard_benchmark.build_data(seed=5, augmentation=augmentation)
        jrig, jscene, jtrain, jtest = _jax_hard_benchmark_data(seed=5, augmentation=augmentation)
    else:
        rig, scene, train_set, test_set = stress_ab.build_data(seed=3)
        jrig, jscene, jtrain, jtest = _jax_stress_data(seed=3)
        if not augmentation:  # the stress scene always augments: its construction without, on both sides
            train_set.augmentation = jtrain.augmentation = False
    for name in ("intrinsic_matrices", "extrinsic_matrices", "worldcoord_from_worldgrid_mat"):
        np.testing.assert_array_equal(getattr(rig, name), getattr(jrig, name))
    assert rig.name == jrig.name and scene.frames() == jscene.frames()
    for frame in (0, len(scene.frames()) - 1):
        np.testing.assert_array_equal(scene.annotation(frame).world_pts, jscene.annotation(frame).world_pts)
    assert train_set.frames == jtrain.frames and test_set.frames == jtest.frames
    _same_batches(train_set, jtrain, augmentation)
    _same_batches(test_set, jtest, False, n=1)


def _finite_moda(line: str) -> float:
    moda = float(re.search(r"moda\s+(-?[\d.]+|nan)", line).group(1))
    assert math.isfinite(moda), line
    return moda


def test_hard_benchmark_twin_runs(monkeypatch, capsys):
    monkeypatch.setattr(hard_benchmark, "RIG", dict(hard_benchmark.RIG, **TINY_RIG))
    monkeypatch.setattr(hard_benchmark, "NUM_FRAME", 4)
    result = hard_benchmark.main(["--device", "cpu", "--epochs", "1", "--num_person", "4", "--floor=-1e9"])
    out = capsys.readouterr().out
    final = [line for line in out.splitlines() if line.startswith("FINAL")]
    assert len(final) == 1 and "windowed attention, cpu" in final[0], out
    assert _finite_moda(final[0]) == pytest.approx(result["moda"], abs=0.05)
    assert "OK: moda" in out
    results = hard_benchmark.main(["--device", "cpu", "--epochs", "1", "--num_person", "4", "--panel",
                                   "--panel_floor=-1e9"])
    out = capsys.readouterr().out
    assert sorted(results) == sorted(hard_benchmark.PANEL_SEEDS) and out.count("FINAL") == 3
    assert "PANEL band" in out and "OK: worst-seed moda" in out


def test_stress_ab_twin_runs(monkeypatch, capsys):
    monkeypatch.setattr(stress_ab, "RIG", dict(stress_ab.RIG, **TINY_RIG))
    monkeypatch.setattr(stress_ab, "NUM_FRAME", 6)
    monkeypatch.setattr(stress_ab, "NUM_PERSON", 4)
    results = stress_ab.main(["--device", "cpu", "--epochs", "1", "--points", "8"])
    out = capsys.readouterr().out
    assert sorted(results) == ["gather/P8", "warped/P8"]  # 8 points in windowed mode run warped
    for label, rec in results.items():
        line = next(ln for ln in out.splitlines() if ln.startswith(label))
        assert _finite_moda(line) == pytest.approx(rec["moda"], abs=0.05)
        # the clamped modes report the clip fraction of a probe step; gather clamps nothing
        assert math.isfinite(rec["clip_frac"]) == (not label.startswith("gather")), (label, rec)


@pytest.mark.parametrize("indexing", ["xy", "ij"])
def test_tune_convergence_twin_runs(monkeypatch, capsys, indexing):
    monkeypatch.setattr(tune_convergence, "RIGS", {k: dict(v, **TINY_RIG) for k, v in tune_convergence.RIGS.items()})
    result = tune_convergence.main(["--device", "cpu", "--epochs", "2", "--num_frame", "6", "--indexing", indexing])
    out = capsys.readouterr().out
    final = [line for line in out.splitlines() if line.startswith(f"[{indexing}] FINAL")]
    assert len(final) == 1 and len(result["losses"]) == 2
    assert _finite_moda(final[0]) == pytest.approx(result["moda"], abs=0.05)


def test_rehearse_realscale_twin_runs(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(rehearse_realscale, "RIG", dict(rehearse_realscale.RIG, img_shape=(108, 192),
                                                        worldgrid_shape=(96, 288)))
    result = rehearse_realscale.main(["--frames", "4", "--workers", "0", "2", "--root", str(tmp_path / "frames"),
                                      "--train_steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "materialized 28 PNGs" in out
    for nw in (0, 2):
        rec = result["pipeline"][nw]
        assert rec["frame_sets_per_s"] > 0 and rec["thread_ms_per_frame_set"]["decode"] > 0, rec
    assert math.isfinite(result["train"]["loss"]) and "ms/step with the DISK pipeline" in out


def test_full_scale_run_twin_runs(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(full_scale_run, "measure_pipeline",
                        functools.partial(full_scale_run.measure_pipeline, n_batches=1))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the CLI's process
    argv = ["--frames", "2", "--epochs", "1", "--workdir", str(tmp_path), "--world_reduce", "16", "--img_reduce",
            "48", "--batch_size", "1", "--num_workers", "1", "--gen_procs", "1", "--device", "cpu", "--bf16", "false"]
    report = full_scale_run.main(argv)
    out = capsys.readouterr().out
    assert "FULL-SCALE REPORT" in out and report["frames"] == 2 and report["train_frames"] == 1
    # a test after each epoch, then the reloaded model's (the CLI's last line)
    assert len(report["moda_per_epoch"]) == 2 and math.isfinite(report["final_moda"])
    assert report["pipeline_fs_per_s"] > 0 and report["peak_hbm_gb"] is None  # no card: the log gives none
    assert full_scale_run.generate_tree(str(tmp_path / "Wildtrack"), 2, 30, 5, 1) == 0.0  # the tree is reused
