"""The shadow configuration (``wildtrack_shadow``: 8 points on each
camera's shadow ray, ``warped`` attention) at a tiny rig on the CPU, in
f32: its reference (``benchmark/reference/shadow.py``) against the
program's forward, the reference map against the program's, the new
attention tied to the frozen windowed one where every height is 0, the
comparison's numbers far inside the configuration's limits, the control
and the faults caught; and the warped mode's formulas by hand and at full
width."""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.formulas import attention, attention_warped, msda_windowed_bwd, msda_windowed_fwd, warp_bwd
from benchmark.harness import cells, check, faults, flops, inputs, readings, system
from benchmark.reference import model, shadow
from benchmark.run import load_layers
from benchmark.tests._tiny import BENCH, CPU, config, limits, load, serve_traffic, train_traffic

MODE = "shadow"


def run(kind, seed):
    fn, traffic = (cells.run_train, train_traffic()) if kind == "train" else (cells.run_serve, serve_traffic())
    return fn(config(MODE), traffic, seed, 0.3, False, CPU, time.perf_counter(), load_layers(), limits(MODE, kind))


def test_reference_map_is_the_programs():
    from mvdetr_tpu_torch.geometry import CameraRig

    cfg = config(MODE)
    rig = inputs.rig_of(cfg)
    port = CameraRig(name="bench_rig", num_cam=rig["num_cam"], img_shape=rig["img_shape"],
                     worldgrid_shape=rig["worldgrid_shape"], indexing=rig["indexing"],
                     worldcoord_unit=rig["worldcoord_unit"], worldcoord_from_worldgrid_mat=rig["worldcoord_from_worldgrid"],
                     intrinsic_matrices=rig["intrinsics"], extrinsic_matrices=rig["extrinsics"])
    ours = shadow.reference_points(rig, cfg["world_reduce"], 2, cfg["shadow_heights_m"])
    want = port.reference_points(world_reduce=cfg["world_reduce"], downsample=2, n_points=8)
    assert ours.shape == want.shape == (8 * 16, 2, 8, 2)
    assert float(np.abs(ours - want).max()) <= 1e-5
    # a non-identity map: the points leave their cell, the z = 0 ones stay on it
    grid = np.stack(np.meshgrid((np.arange(16) + 0.5) / 16, (np.arange(8) + 0.5) / 8), -1).reshape(-1, 1, 2)
    assert float(np.abs(ours[:, :, 7] - grid).max()) > 0.1 and float(np.abs(ours[:, :, 2] - grid).max()) < 1e-5


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_program(train):
    from mvdetr_tpu_torch.models.layers import set_dropout_generator

    cfg = config(MODE)
    rig = inputs.rig_of(cfg)
    weights = inputs.make_weights(cfg, rig, 11, CPU)
    batch = inputs.train_pool(cfg, train_traffic(), rig, inputs.Seeds(3), CPU)[0]
    program = system.build_model(cfg, rig, weights, CPU).train(train)
    assert {m.mode for m in program.modules() if type(m).__name__ == "MSDeformAttn"} == {"warped"}
    reference = shadow.MVDeTr(cfg, rig)
    reference.load_state_dict(weights)
    reference.train(train)
    set_dropout_generator(program, torch.Generator().manual_seed(4))  # the same masks on both sides
    with torch.no_grad():
        ours, _ = program(torch.from_numpy(batch["imgs"]), torch.from_numpy(batch["affine_mats"]))
        ref = reference(torch.from_numpy(batch["imgs"]), shadow.warp_coords(cfg, rig, batch["affine_mats"]),
                        torch.Generator().manual_seed(4) if train else None)
    for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


def test_heights_at_zero_give_the_frozen_windowed_attention():
    """At z = 0 the map is the identity grid: the resample hands every
    level's map back, and the 56 one-point maps are the windowed attention
    of ``model.py`` at 8 points, the softmax over the same (level, point)."""
    cfg = {**config(MODE), "shadow_heights_m": [0.0] * 8}
    rig = inputs.rig_of(cfg)
    hs, ws = 8, 16
    ref = shadow.reference_points(rig, cfg["world_reduce"], 2, cfg["shadow_heights_m"])
    prec = model.Precision()
    warped = shadow.WarpedAttn(prec, 128, 2, 8, 8, 4, shadow.shadow_pixels(ref, hs, ws))
    windowed = model.MSDeformAttn(prec, 128, 2, 8, 8, "windowed", 4, None)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in warped.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (2.0 if p.shape[0] == 8 * 2 * 8 * 2 else 0.3))
    windowed.load_state_dict(warped.state_dict())
    query = torch.randn(1, 2 * hs * ws, 128, generator=gen)
    src = torch.randn(1, 2 * hs * ws, 128, generator=gen)
    with torch.no_grad():
        a, b = warped(query, src, hs, ws), windowed(query, src, hs, ws)
        reach = float(warped.sampling_offsets(query).abs().max())
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert reach > 4  # the offsets reach past the clamp: the comparison sees the window


def test_training_numbers_far_inside_the_limits():
    out = run("train", 5)
    numbers = out["numbers"]
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad_gap"] < 2e-2
    assert numbers["grad_median_gap"] < 3e-3
    assert numbers["delta_gap"] < 2e-2


def test_serving_numbers_far_inside_the_limits():
    out = run("serve", 6)
    numbers = out["numbers"]
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert numbers["detection_gap"] < 1e-3
    assert numbers["rank_gap"] < 1e-3
    assert numbers["keep_gap"] == 0


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_control_fails(kind):
    numbers = readings.control_numbers(config(MODE), train_traffic() if kind == "train" else serve_traffic(), 31, CPU)
    correct, checks = check.judge(numbers, limits(MODE, kind))
    assert correct is False, checks


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_broken_train_step_is_caught(fault):
    with faults.planted(fault):
        assert run("train", 21)["correct"] is False


# the warped formulas at a small shape: B=1, 2 cameras, a 4x6 encoder grid (8x12 reduced), M=2, D=4, P=3, 2 layers
SMALL = {"num_cam": 2, "worldgrid_shape": [32, 48], "world_reduce": 4, "hidden_dim": 8, "nhead": 2, "head_dim": 4,
         "n_points": 3, "enc_layers": 2}


def test_warped_sampling_by_hand():
    sh = attention.shape_of(SMALL, 1)
    assert sh == {"b": 1, "l": 2, "q": 48, "s": 48, "c": 8, "m": 2, "d": 4, "p": 3, "layers": 2}
    samples = 48 * 2 * 2 * 3  # queries x heads x levels x points
    entries = 3 * 48 * 2 * 4  # points x tokens x heads x channels
    assert attention_warped.stack_entries(sh) == entries == 1152
    assert attention_warped.sampling_flops(sh, False) == 10 * samples * 4 + 8 * entries == 32_256
    assert attention_warped.sampling_flops(sh, True) == 40 * samples * 4 + 8 * entries + 12 * entries == 115_200
    assert attention_warped.sampling_flops(sh, True) == (msda_windowed_fwd.flops(samples, 4)
                                                         + msda_windowed_bwd.flops(samples, 4)
                                                         + 20 * entries)


def test_warped_b3_calls_by_hand():
    # one call a layer: 2 maps (B x cameras) of 4x6 cells, 3 samples a cell, 8 channels
    assert attention_warped.b3_calls(SMALL, 1) == [(2 * 24 * 3 * 8, 2 * 24 * 8, 2 * 24 * 3)] * 2
    assert attention_warped.b3_calls(SMALL, 2)[0] == (4 * 24 * 3 * 8, 4 * 24 * 8, 4 * 24 * 3)


def _full_width() -> tuple:
    cfg = load("configs", "wildtrack_shadow.json")
    rig = inputs.rig_of(cfg)
    return (flops.count_flops(cfg, rig, 2, True), attention_warped.least_step_seconds(cfg, 2, True),
            flops.b3_least_seconds(cfg, 2))


def test_full_width_counts_are_finite_and_repeat():
    """A train step's FLOPs, the attention's and B3's least times at the
    cell's size, by hand, and the same in a second process that loads
    nothing of the program."""
    cfg = load("configs", "wildtrack_shadow.json")
    first = _full_width()
    assert all(math.isfinite(x) and x > 0 for x in first)
    train, attn_s, b3_s = first
    # the windowed step's products, the wider offset and weight projections (3 x 224 more columns, forward and
    # two backward products, three layers), and the warped sampling of three layers
    sh = attention.shape_of(cfg, 2)
    extra = 3 * 3 * 2 * 2 * 75_600 * 128 * (3 * 224)
    assert train == 15_144_556_953_600 + extra + 3 * attention_warped.sampling_flops(sh, True)
    # the camera warp's B3 and three shadow warps': 211.3 MB + 3 x 358.0 MB at 3.35 TB/s
    assert b3_s == pytest.approx((211_276_800 + 3 * 358_041_600) / 3.35e12, rel=1e-12)
    assert warp_bwd.nbytes(*attention_warped.b3_calls(cfg, 2)[0], 2) == 358_041_600
    assert attn_s > flops.attention_formula(load("configs", "wildtrack_windowed.json")).least_step_seconds(
        load("configs", "wildtrack_windowed.json"), 2, True)
    code = ("import sys, json; sys.path.insert(0, '.')\n"
            "from benchmark.tests import test_bench_shadow as t\n"
            "print(json.dumps(t._full_width()))\n"
            "print(any(m.split('.')[0] == 'mvdetr_tpu_torch' for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(BENCH), capture_output=True, text=True,
                         check=True, timeout=600).stdout.split("\n")
    assert tuple(json.loads(out[0])) == pytest.approx(first, rel=0) and out[1] == "False"
