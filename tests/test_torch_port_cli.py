"""The port's experiment runner, ``python -m mvdetr_tpu_torch.cli``, on the CPU:

- its parser has every dest and default of ``mvdetr_tpu.cli.build_parser``,
  plus ``--device`` (default ``cuda``);
- one tiny ``deform_trans`` epoch with ``--device cpu`` writes ``log.txt``,
  ``test.txt``, ``checkpoints/<step>`` and the source snapshot (without
  ``_build/`` and ``__pycache__``);
- ``--epochs_per_process 1`` then ``--resume_train`` continues at epoch 2 from
  the saved step, appending to the log; ``--resume`` reloads and tests;
- ``--visualize`` writes the figures of the test, ``--view_shards 2`` in one
  process fails before any work, and so does the default device without a
  card; the fusion variants, VGG-11 and ``--remat_backbone`` each run a tiny
  epoch;
- the sharding and multi-process flags on one process resolve or fail up
  front.

Each run restores ``sys.stdout`` after the CLI's tee.
"""

import sys

import pytest
import torch

from mvdetr_tpu.cli import build_parser as jax_build_parser
from mvdetr_tpu_torch import cli

from _torch_port import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TINY = ["-d", "synthetic", "--device", "cpu", "--synthetic_cams", "2", "--synthetic_frames", "6",
        "--synthetic_img", "48", "96", "--synthetic_grid", "32", "64", "--world_reduce", "2",
        "--cls_thres", "0.3", "--batch_size", "2", "-j", "2"]


def _run(argv):
    saved = sys.stdout
    try:
        return cli.main(argv)
    finally:
        if sys.stdout is not saved:
            sys.stdout.close()
        sys.stdout = saved


def test_parser_has_every_dest_and_default_of_the_jax_cli():
    ours, ref = vars(cli.build_parser().parse_args([])), vars(jax_build_parser().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == ref
    ours_actions = {a.dest: a for a in cli.build_parser()._actions}
    for action in jax_build_parser()._actions:
        mine = ours_actions[action.dest]
        assert mine.option_strings == action.option_strings and mine.choices == action.choices, action.dest
        assert mine.nargs == action.nargs and mine.default == action.default, action.dest
        assert getattr(mine.type, "__name__", None) == getattr(action.type, "__name__", None), action.dest


def test_one_epoch_writes_the_logdir(tmp_path):
    logdir = tmp_path / "run"
    trainer = _run(TINY + ["--epochs", "1", "--logdir", str(logdir), "--deterministic", "true"])
    assert trainer.state.step == 2  # 5 train frames at batch 2
    log = (logdir / "log.txt").read_text()
    assert "determinism check passed" in log and "Train epoch 1 done" in log and log.count("Test: loss") == 2
    assert (logdir / "test.txt").exists()
    assert (logdir / "checkpoints" / "2" / "state.pt").is_file()
    snap = logdir / "scripts" / "mvdetr_tpu_torch"
    assert (snap / "cli.py").is_file() and (snap / "native" / "dataio.cpp").is_file()
    assert not list(snap.rglob("_build")) and not list(snap.rglob("__pycache__"))


def test_epochs_per_process_then_resume_train_continues(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    logdir = tmp_path / "logs" / "synthetic" / "run"
    base = TINY + ["--epochs", "2", "--logdir", "logs/synthetic/run"]
    first = _run(base + ["--epochs_per_process", "1"])
    assert first.state.step == 2 and first.state.scheduler.last_epoch == 2
    log = (logdir / "log.txt").read_text()
    assert "epochs_per_process budget reached at epoch 1" in log and "=== epoch 2" not in log

    second = _run(base + ["--resume_train", "run"])
    assert second.state.step == 4
    log = (logdir / "log.txt").read_text()
    assert "restored step 2 -> continuing at epoch 2/2" in log
    assert log.count("=== epoch") == 2  # appended, not truncated
    assert sorted(p.name for p in (logdir / "checkpoints").iterdir()) == ["2", "4"]
    assert second.state.scheduler.last_epoch == 3  # went on from step 2; held at the cycle's last step

    third = _run(TINY + ["--resume", "run"])  # weights only, then a test
    assert third.state.step == 0 and third.state.optimizer.state_dict()["state"] == {}
    for key, value in second.state.model.state_dict().items():
        assert torch.equal(third.state.model.state_dict()[key], value), key


@pytest.mark.parametrize("flags", [["--view_shards", "2"], ["--visualize"]])
def test_unported_flags_raise_before_any_work(flags, tmp_path, monkeypatch):
    """The two flags that raised until camera sharding and visualisation
    were ported: ``--view_shards 2`` in one process now fails up front, as
    any mesh the processes cannot form does (nothing written), and
    ``--visualize`` runs a tiny epoch whose test writes JAX's figures into
    ``logdir/visualize``."""
    monkeypatch.chdir(tmp_path)
    if flags == ["--view_shards", "2"]:
        with pytest.raises(ValueError, match="do not form the mesh data=1 x view=2 x bev=1 .*--num_processes 2"):
            _run(TINY + flags)
        assert list(tmp_path.iterdir()) == []  # no logdir, no build, nothing
        return
    trainer = _run(TINY + flags + ["--epochs", "1", "--logdir", "run"])
    figures = tmp_path / "run" / "visualize"
    assert sorted(p.name for p in figures.iterdir()) == sorted(trainer.FIGURES)


@pytest.mark.parametrize("flags, error", [
    (["--bev_shards", "2"], "1 process\\(es\\) do not form the mesh data=1 x view=1 x bev=2 .*--num_processes 2"),
    (["--num_processes", "2"], "--num_processes 2 needs --process_id and --coordinator_address"),
    (["--coordinator_address", "h:1"], None),
], ids=["bev_shards", "num_processes", "coordinator_address"])
def test_multi_process_flags_on_one_process(flags, error, tmp_path, monkeypatch):
    """The sharding and multi-process flags in a single process: a mesh that
    needs more processes than the run has, and a process count without the
    rank and rendezvous, fail before any work; a coordinator address alone is
    ignored, as in the JAX CLI, and a tiny epoch runs unsharded. Two
    processes are run by tests/test_torch_port_parallel.py."""
    monkeypatch.chdir(tmp_path)
    if error is not None:
        with pytest.raises(ValueError, match=error):
            _run(TINY + flags)
        assert list(tmp_path.iterdir()) == []
        return
    trainer = _run(TINY + flags + ["--epochs", "1", "--logdir", str(tmp_path / "run")])
    assert trainer.mesh is None and trainer.state.step == 2
    assert "Test: loss" in (tmp_path / "run" / "log.txt").read_text()


@pytest.mark.parametrize("flags", [
    ["--world_feat", "trans"], ["--arch", "vgg11"], ["--world_feat", "conv"], ["--world_feat", "deform_conv"],
    ["--remat_backbone", "true"],
], ids=lambda f: "-".join(a.strip("-") for a in f))
def test_variant_flags_run_an_epoch(flags, tmp_path):
    """The flags that raised until the fusion variants, VGG-11 and remat were
    ported: each runs one tiny epoch and its test."""
    trainer = _run(TINY + flags + ["--epochs", "1", "--logdir", str(tmp_path / "run")])
    model = trainer.state.model
    assert trainer.state.step == 2 and model.arch == ("vgg11" if "vgg11" in flags else "resnet18")
    if "--world_feat" in flags:
        assert type(model.world_feat).__name__ == {"trans": "TransformerWorldFeat", "conv": "ConvWorldFeat",
                                                   "deform_conv": "DeformConvWorldFeat"}[flags[1]]
    assert all(b.remat == ("--remat_backbone" in flags) for b in model.base.modules() if hasattr(b, "remat"))
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "Train epoch 1 done" in log and log.count("Test: loss") == 2


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(argv)
    assert list(tmp_path.iterdir()) == []
