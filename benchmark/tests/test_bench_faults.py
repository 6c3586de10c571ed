"""A whole run of a cell (the chip's look skipped: on the CPU, at a tiny
rig) with its timed path broken underneath comes out not correct under the
cells' limits; the same run unbroken comes out correct. A cell on one chip
has no exchange between chips to leave out."""

import time

import pytest

from benchmark.harness import cells, faults
from benchmark.run import load_layers
from benchmark.tests._tiny import CPU, MODES, config, limits, serve_traffic, train_traffic


def run(mode, kind, seed):
    fn, traffic = (cells.run_train, train_traffic()) if kind == "train" else (cells.run_serve, serve_traffic())
    return fn(config(mode), traffic, seed, 0.3, False, CPU, time.perf_counter(), load_layers(), limits(mode, kind))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_train_step_is_caught(mode, fault):
    with faults.planted(fault):
        assert run(mode, "train", 21)["correct"] is False


@pytest.mark.parametrize("mode", MODES)
def test_altered_answer_is_caught(mode):
    with faults.planted("altered_answer"):
        assert run(mode, "serve", 22)["correct"] is False


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_sound_run_is_correct(mode, kind):
    out = run(mode, kind, 23)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
