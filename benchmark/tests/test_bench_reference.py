"""The frozen reference against the program's plain path on the CPU, at a
tiny rig in f32, in both attention modes: the forward's outputs on the same
weights and frames, and the comparison's numbers over three training steps
and over served answers, far inside the limits."""

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, readings, system
from benchmark.reference.model import MVDeTr, warp_coords
from benchmark.tests._tiny import CPU, MODES, config, serve_traffic, train_traffic


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_program(mode, train):
    cfg = config(mode)
    rig = inputs.rig_of(cfg)
    weights = inputs.make_weights(cfg, rig, 11, CPU)
    pool = inputs.train_pool(cfg, train_traffic(), rig, inputs.Seeds(3), CPU)
    batch = pool[0]
    program = system.build_model(cfg, rig, weights, CPU).train(train)
    reference = MVDeTr(cfg, rig)
    reference.load_state_dict(weights)
    reference.train(train)
    from mvdetr_tpu_torch.models.layers import set_dropout_generator

    set_dropout_generator(program, torch.Generator().manual_seed(4))  # the same masks on both sides
    with torch.no_grad():
        ours, _ = program(torch.from_numpy(batch["imgs"]), torch.from_numpy(batch["affine_mats"]))
        ref = reference(torch.from_numpy(batch["imgs"]), warp_coords(cfg, rig, batch["affine_mats"]),
                        torch.Generator().manual_seed(4) if train else None)
    for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
        scale = float(b.abs().max())
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, scale)


@pytest.mark.parametrize("mode", MODES)
def test_training_numbers_far_inside_the_limits(mode):
    numbers = readings.program_numbers(config(mode), train_traffic(), 5, CPU)
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad_gap"] < 2e-2
    assert numbers["grad_median_gap"] < 3e-3
    assert numbers["delta_gap"] < 2e-2


@pytest.mark.parametrize("mode", MODES)
def test_serving_numbers_far_inside_the_limits(mode):
    numbers = readings.program_numbers(config(mode), serve_traffic(), 6, CPU, seconds=0.6)
    assert numbers["detection_gap"] < 1e-3
    assert numbers["rank_gap"] < 1e-3
    assert numbers["keep_gap"] == 0


def test_greedy_nms_by_hand():
    from benchmark.reference.decode import greedy_nms

    pts = np.array([[0, 0], [10, 0], [30, 0], [45, 0]], dtype=np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.95], dtype=np.float32)
    # 3 (best) keeps, 2 is 15 away: dropped; 0 keeps, 1 is 10 from 0: dropped
    assert greedy_nms(pts, scores, 20.0).tolist() == [True, False, False, True]


def test_fp8_control_rounds():
    x = torch.linspace(-3, 3, 1001)
    from benchmark.reference.model import Precision

    y = Precision("fp8")(x)
    assert 0 < float((y - x).abs().max()) <= 3 * 2.0**-3  # e5m2: 2 mantissa bits
    assert torch.equal(Precision("f32")(x), x)


def test_grad_gap_sees_one_leaf_and_grad_median_gap_every_leaf():
    from benchmark.harness.check import BETA1_FIRST_STEP, train_numbers

    ref = {"loss": [1.0], "moment": {f"w{i}": (1.0 + i) * (1 - BETA1_FIRST_STEP) for i in range(21)},
           "delta": {f"w{i}": 1.0 for i in range(21)}}
    one = {**ref, "moment": {**ref["moment"], "w20": ref["moment"]["w20"] * 1.3}}  # an L1 sign flipped in one leaf
    every = {**ref, "moment": {n: v * 1.1 for n, v in ref["moment"].items()}}  # half a batch: every leaf moves
    assert train_numbers(one, ref)["grad_median_gap"] == 0.0
    assert train_numbers(one, ref)["grad_gap"] == pytest.approx(0.3)  # 6.3 over the leaf's own 21
    assert train_numbers(every, ref)["grad_median_gap"] == pytest.approx(0.1)
    assert train_numbers(every, ref)["grad_gap"] == pytest.approx(0.1)
