"""The day-one command path of the port on a Wildtrack-format PNG tree
(``mvdetr_tpu_torch/data/trees.py``), on the CPU:

- one epoch of ``python -m mvdetr_tpu_torch.cli -d wildtrack --data_root
  <tree> --device cpu --world_reduce 8 --img_reduce 24``, as
  ``tests/test_day_one.py`` drives the JAX package's (a 2-frame tree: one
  train and one test frame, so the epoch stays a test of the path, not of
  the CPU's speed);
- the day-one rehearsal's twin (``scripts/rehearse_day_one.py``) on a tree
  of its own at a small reduction: a seeded reference-format checkpoint
  evaluated through ``--load_torch_ckpt`` in windowed mode at radius 8;
- marked ``slow``, as the JAX package marks its own: the port's copy of
  ``tests/test_day_one.py`` (the Wildtrack CLI with its byte-identical
  resume, training that learns through the adapters, the MultiviewX CLI).
"""

import math
import os
import re
import sys

import numpy as np
import pytest

from mvdetr_tpu_torch.data.trees import (
    multiviewx_like_scene, wildtrack_like_scene, write_multiviewx_tree, write_wildtrack_tree,
)
from mvdetr_tpu_torch.scripts import rehearse_day_one

from _torch_port import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _cli(argv):
    """``cli.main(argv)``; the CLI tees stdout into its log, and the tee is
    closed and the real stdout put back after."""
    from mvdetr_tpu_torch.cli import main

    saved = sys.stdout
    try:
        return main(argv)
    finally:
        if sys.stdout is not saved:
            sys.stdout.close()
            sys.stdout = saved


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("day_one") / "Wildtrack"
    write_wildtrack_tree(str(root), wildtrack_like_scene(num_frame=2, num_person=6))
    return root


def test_cli_epoch_on_a_png_tree(small_tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    logdir = tmp_path / "run"
    trainer = _cli(["-d", "wildtrack", "--data_root", str(small_tree), "--device", "cpu", "--epochs", "1",
                    "--world_reduce", "8", "--img_reduce", "24", "--num_workers", "2", "--cls_thres", "0.3",
                    "--logdir", str(logdir)])
    assert trainer.state.step == 1 and trainer.train_set.rig.name == "Wildtrack"
    assert trainer.train_set.input_shape == (360, 640) and trainer.train_set.Rworld_shape == (60, 180)
    log = (logdir / "log.txt").read_text()
    tests = re.findall(r"Test: loss ([\d.]+), moda (-?[\d.]+)%", log)
    assert len(tests) == 2 and all(math.isfinite(float(v)) for t in tests for v in t), log
    assert (logdir / "test.txt").exists() and os.listdir(logdir / "checkpoints")


def test_rehearse_day_one_twin_runs(tmp_path, capsys):
    trainer = rehearse_day_one.main(["--frames", "2", "--workdir", str(tmp_path / "day1"), "--world_reduce", "16",
                                     "--img_reduce", "48", "--device", "cpu"])
    out = capsys.readouterr().out
    tests = [line for line in out.splitlines() if line.startswith("Test: loss")]
    assert len(tests) == 1 and math.isfinite(float(re.search(r"moda (-?[\d.]+)%", tests[0]).group(1)))
    assert "[3/3] day-one eval command completed" in out and "Eval offset_clip_fraction 0.0000" in out
    model = trainer.state.model
    assert model.world_feat.mode == "windowed" and model.world_feat.encoder.layers[0].self_attn.radius == 8
    assert model.warp_convention == "kornia" and trainer.state.step == 0


@pytest.mark.slow
def test_day_one_wildtrack_cli(tmp_path, monkeypatch):
    scene = wildtrack_like_scene(num_frame=10, num_person=10)
    root = tmp_path / "Wildtrack"
    write_wildtrack_tree(str(root), scene)
    assert len(os.listdir(root / "Image_subsets")) == 7
    assert len(os.listdir(root / "annotations_positions")) == 10

    monkeypatch.chdir(tmp_path)
    args = ["-d", "wildtrack", "--data_root", str(root), "--epochs", "1", "--world_reduce", "8", "--img_reduce", "24",
            "--num_workers", "2", "--cls_thres", "0.3", "--device", "cpu"]
    assert _cli(args) is not None
    logdirs = list((tmp_path / "logs" / "wildtrack").iterdir())
    assert len(logdirs) == 1
    logdir = logdirs[0]
    for name in ("log.txt", "test.txt", "checkpoints"):
        assert (logdir / name).exists(), name
    res_bytes = (logdir / "test.txt").read_bytes()
    # resume: weights-only reload from the checkpoint, then eval: the same detections byte for byte
    assert _cli(args + ["--resume", logdir.name]) is not None
    assert (logdir / "test.txt").read_bytes() == res_bytes


@pytest.mark.slow
def test_day_one_adapter_learning(tmp_path, monkeypatch):
    """Training through the on-disk tree learns: detections are nonzero and
    MODA clears the JAX package's floor of 20 with its recipe (conv fusion,
    heavy reduces) at 24 epochs, not 14: the PNG frames keep the render's
    noise, which the JAX test's JPEGs smooth, and 14 epochs on PNG frames
    leave the JAX package itself under the floor too."""
    scene = wildtrack_like_scene(num_frame=12, num_person=12, cache_images=False)
    root = tmp_path / "Wildtrack"
    write_wildtrack_tree(str(root), scene)

    monkeypatch.chdir(tmp_path)
    trainer = _cli(["-d", "wildtrack", "--data_root", str(root), "--epochs", "24", "--world_feat", "conv",
                    "--world_reduce", "16", "--img_reduce", "48", "--world_kernel_size", "4", "--img_kernel_size",
                    "4", "--num_workers", "2", "--cls_thres", "0.35", "-b", "2", "--lr", "1e-3", "--logdir",
                    str(tmp_path / "run"), "--device", "cpu"])
    _, moda, _, _, _ = trainer.test(batch_size=2)
    det = np.loadtxt(tmp_path / "run" / "test.txt")
    assert det.size > 0, "day-one training produced an empty test.txt"
    assert moda > 20.0, f"adapter-fed training failed to learn: moda {moda}"


@pytest.mark.slow
def test_day_one_multiviewx_cli(tmp_path, monkeypatch):
    root = tmp_path / "MultiviewX"
    write_multiviewx_tree(str(root), multiviewx_like_scene(num_frame=6, num_person=8))
    monkeypatch.chdir(tmp_path)
    trainer = _cli(["-d", "multiviewx", "--data_root", str(root), "--epochs", "1", "--world_feat", "conv",
                    "--use_mse", "true", "--world_reduce", "16", "--img_reduce", "48", "--num_workers", "2",
                    "--cls_thres", "0.3", "--device", "cpu"])
    assert trainer is not None
    logdirs = list((tmp_path / "logs" / "multiviewx").iterdir())
    assert (logdirs[0] / "test.txt").exists()
