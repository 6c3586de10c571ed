"""The control, the reference in float8 put in the program's place, comes
out not correct under each cell's limits: at a tiny rig on the CPU, and on
the card where there is one (``cuda``). Its readings at the cells' own size
come from ``benchmark/control.py`` on the card."""

import pytest
import torch

from benchmark.harness import check, readings
from benchmark.tests._tiny import CPU, MODES, config, limits, serve_traffic, train_traffic


def control_fails(mode, kind, seed, device):
    traffic = train_traffic() if kind == "train" else serve_traffic()
    numbers = readings.control_numbers(config(mode), traffic, seed, device)
    correct, checks = check.judge(numbers, limits(mode, kind))
    return correct is False, checks


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_control_fails_on_the_cpu(mode, kind):
    failed, checks = control_fails(mode, kind, 31, CPU)
    assert failed, checks


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_control_fails_on_the_card(mode, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    failed, checks = control_fails(mode, kind, 32, torch.device("cuda", 0))
    assert failed, checks
