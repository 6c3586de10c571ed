"""The counts the per-layer metrics divide by: the step's FLOPs, from the
frozen reference and repeatable, and the frozen byte and FLOP formulas
against hand counts at the four cells' shapes."""

import json
import os
import subprocess
import sys

from benchmark.formulas import attention, msda_gather, msda_windowed_bwd, msda_windowed_fwd, warp_bwd
from benchmark.harness import flops, inputs
from benchmark.tests._tiny import BENCH, config, load

ROOT = os.path.dirname(BENCH)


def test_step_flops_repeat_and_come_from_the_reference():
    cfg = config("windowed")
    rig = inputs.rig_of(cfg)
    first = flops.count_flops(cfg, rig, 2, True)
    assert first == flops.count_flops(cfg, rig, 2, True) > 0
    code = ("import sys, json; sys.path.insert(0, '.')\n"
            "from benchmark.harness import flops, inputs\n"
            f"cfg = json.loads({json.dumps(json.dumps(cfg))})\n"
            "print(flops.count_flops(cfg, inputs.rig_of(cfg), 2, True))\n"
            "print(any(m.split('.')[0] == 'mvdetr_tpu_torch' for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True,
                         timeout=600).stdout.split()
    assert int(out[0]) == first and out[1] == "False"  # the same count, and the program never loaded


def test_full_step_flops():
    cfg = load("configs", "wildtrack_windowed.json")
    rig = inputs.rig_of(cfg)
    # convolutions and products of a batch-2 step (15.1446 TFLOP) and the sampling's 40 a sample-channel
    samples = 2 * 7 * 60 * 180 * 8 * 7 * 4
    assert flops.count_flops(cfg, rig, 2, True) == 15_144_556_953_600 + 3 * 40 * samples * 16


# sizes of the four cells: B=2 (train) or 1 (serve), 7 cameras, the 60x180 encoder grid, M=8, D=16, P=4
def _samples(b):
    return b * 7 * 60 * 180 * 8 * 7 * 4


def test_b1_b2_by_hand():
    samples, value, out = _samples(2), 2 * 7 * 60 * 180 * 128, 2 * 7 * 60 * 180 * 128
    assert samples == 33_868_800
    assert msda_windowed_fwd.flops(samples, 16) == 5_419_008_000
    assert msda_windowed_fwd.nbytes(value, samples, out) == 522_547_200  # 2 * 19.35 M + 4 * (3 * 33.87 M + 19.35 M)
    assert msda_windowed_bwd.flops(samples, 16) == 16_257_024_000
    assert msda_windowed_bwd.nbytes(value, samples, out) == 1_006_387_200
    assert msda_windowed_fwd.flops(_samples(1), 16) == 2_709_504_000  # a request


def test_b3_by_hand():
    g, o, s = 14 * 120 * 360 * 128, 14 * 90 * 160 * 128, 14 * 120 * 360  # the camera warp, batch 2
    assert warp_bwd.nbytes(g, o, s, 2) == 211_276_800 and warp_bwd.flops(g) == 928_972_800
    g, o, s = 112 * 302_400 * 16, 112 * 60 * 180 * 16, 112 * 302_400  # gather's value gradient
    assert warp_bwd.nbytes(g, o, s, 2) == 1_393_459_200 and warp_bwd.flops(g) == 6_502_809_600


def test_gather_sampling_by_hand():
    samples, value, out = _samples(2), 2 * 7 * 60 * 180 * 128, 2 * 7 * 60 * 180 * 128
    assert msda_gather.flops(samples, 16, False) == 5_419_008_000
    assert msda_gather.flops(samples, 16, True) == 16_257_024_000
    assert msda_gather.nbytes(value, samples, out, False) == 2 * value + 10 * samples + 2 * out == 416_102_400
    assert msda_gather.flops(_samples(1), 16, False) == 2_709_504_000


def test_attention_and_b3_least_times():
    cfg = load("configs", "wildtrack_gather.json")
    sh = attention.shape_of(cfg, 2)
    assert sh == {"b": 2, "l": 7, "q": 75_600, "s": 75_600, "c": 128, "m": 8, "d": 16, "p": 4, "layers": 3}
    nbytes, products = attention.module_work(sh, False)
    assert products == 2 * 2 * (75_600 * 128 * 128 * 2 + 75_600 * 128 * 224 * 3)
    # the camera warp's B3 and three value gradients: 211.3 MB + 3 x 1393.5 MB at 3.35 TB/s
    assert abs(flops.b3_least_seconds(cfg, 2) - (211_276_800 + 3 * 1_393_459_200) / 3.35e12) < 1e-12
