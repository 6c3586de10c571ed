"""The trace reduction and every per-layer reader on a hand-built trace."""

import glob
import importlib.util
import os

import pytest

from benchmark.harness.trace import reduce_trace
from benchmark.run import load_layers
from benchmark.tests._tiny import BENCH


def op(name, tid, ts, dur, seq=None, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur,
            "args": {} if seq is None else {"Sequence number": seq}}


def launch(tid, ts, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid, "ts": ts, "dur": 2, "args": {"correlation": corr}}


def device(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "tid": 7, "ts": ts, "dur": dur, "args": {"correlation": corr}}


EVAL = "autograd::engine::evaluate_function: "
EVENTS = [
    op("bench:window", 1, 0, 1000, cat="user_annotation"),
    op("bench:trunk", 1, 5, 100, cat="user_annotation"),
    op("bench:normalisation", 1, 10, 20, cat="user_annotation"),
    op("aten::mul", 1, 12, 5, seq=5), launch(1, 13, 1), device("norm_fwd", 100, 50, 1),
    op("aten::conv", 1, 40, 10, seq=6), launch(1, 42, 2), device("conv", 200, 100, 2),
    op(EVAL + "MulBackward0", 2, 300, 20, seq=5), launch(2, 305, 3), device("mul_bwd", 400, 30, 3),
    op(EVAL + "ConvolutionBackward0", 2, 330, 20, seq=6), launch(2, 335, 4), device("conv_bwd", 450, 60, 4),
    op(EVAL + "PatchBackward", 2, 500, 100, seq=99), launch(2, 510, 5), device("warp_bwd_keys", 600, 10, 5),
    launch(2, 520, 6, "cudaMemsetAsync"), device("Memset (Device)", 615, 1, 6, "gpu_memset"),
    launch(2, 530, 7), device("warp_bwd_walk", 620, 20, 7),
    op("bench:upload", 1, 700, 50, cat="user_annotation"), launch(1, 710, 8, "cudaMemcpyAsync"),
    device("Memcpy HtoD (Pageable -> Device)", 720, 40, 8, "gpu_memcpy"),
    op("bench:decode_nms", 1, 800, 150, cat="user_annotation"), op("aten::item", 1, 810, 120),
]


@pytest.fixture
def rec():
    r = reduce_trace(EVENTS, load_layers())
    r.update(units=1, window_s=0.001, service_s=0.002, dispatch_s=[0.01, 0.03], queue_s=[0.002, 0.004], batch=2)
    return r


CTX = {"flops_per_unit": 0.5 * 989e12 * 0.001, "attention_least_s": 1e-6, "b3_least_s": 15.5e-6}
EXPECTED = {"mfu.train": 50.0, "mfu.serve": 25.0, "dispatch_ms.train": 20.0, "queue_ms.serve": 3.0,
            "h2d_ms.serve": 0.04, "device_ms.norm.train": 0.08, "device_ms.trunk.train": 0.16,
            "device_ms.attention.train": None, "device_ms.attention.serve": None,
            "attention_roofline.train": None, "attention_roofline.serve": None, "B3_roofline.train": 50.0,
            "decode_nms_ms.serve": 0.15, "device_idle_share.train": 68.9, "device_idle_share.serve": 68.9}


def test_reduction(rec):
    assert rec["busy_s"] == pytest.approx(311e-6)
    assert rec["idle_gaps"][0] == ("aten::item", pytest.approx(240e-6))  # 760..1000, its middle in the sync at 810..930
    assert rec["device_ops"][0] == ("conv", pytest.approx(100e-6))


def readers():
    return sorted(glob.glob(os.path.join(BENCH, "metrics", "*.*.py")))


def test_every_reader_has_a_case():
    assert {os.path.basename(p)[:-3] for p in readers()} == set(EXPECTED)


@pytest.mark.parametrize("path", readers(), ids=lambda p: os.path.basename(p)[:-3])
def test_reader(path, rec):
    spec = importlib.util.spec_from_file_location("reader", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    want = EXPECTED[os.path.basename(path)[:-3]]
    got = module.read(rec, CTX)
    assert got == (None if want is None else pytest.approx(want, rel=1e-9))
