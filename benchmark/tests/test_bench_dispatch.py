"""A configuration names its reference module (``"reference"``, default
``model``), and every site that builds or runs the reference goes through
:func:`benchmark.harness.reference.of`: a stub module named by a
configuration is reached at all five sites, a name that is not a plain
identifier is refused, and the two configurations, which name none, read
what they read before the key existed (values written in from that code)."""

import hashlib
import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark.harness import cells, check, flops, inputs, reference
from benchmark.reference import model
from benchmark.run import load_layers
from benchmark.tests._tiny import CPU, MODES, config, limits, load, serve_traffic, train_traffic

STUB = "stub_for_tests"


def _stub(calls: list) -> types.ModuleType:
    """A reference module that delegates to ``model`` and records each call
    with the function that made it."""
    mod = types.ModuleType(f"benchmark.reference.{STUB}")

    def record(name):
        calls.append((name, sys._getframe(2).f_code.co_qualname))

    def MVDeTr(cfg, rig, precision="f32"):
        record("MVDeTr")
        return model.MVDeTr(cfg, rig, precision)

    def warp_coords(cfg, rig, affines):
        record("warp_coords")
        return model.warp_coords(cfg, rig, affines)

    def offset_bias(cfg):
        record("offset_bias")
        return model.offset_bias(cfg)

    mod.MVDeTr, mod.warp_coords, mod.offset_bias = MVDeTr, warp_coords, offset_bias
    return mod


@pytest.fixture
def stubbed(monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, f"benchmark.reference.{STUB}", _stub(calls))
    return calls


def _run(cfg, kind, seed):
    mode = cfg["attn_mode"]
    fn, traffic = (cells.run_train, train_traffic()) if kind == "train" else (cells.run_serve, serve_traffic())
    return fn(cfg, traffic, seed, 0.3, False, CPU, time.perf_counter(), load_layers(), limits(mode, kind))


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_named_reference_is_reached_at_every_site(stubbed, kind):
    cfg = dict(config("windowed"), reference=STUB)
    out = _run(cfg, kind, 31)
    sites = {"train": {("MVDeTr", "make_weights"), ("offset_bias", "make_weights"),
                       ("MVDeTr", "Trainer.__init__"), ("warp_coords", "Trainer.step")},
             "serve": {("MVDeTr", "make_weights"), ("offset_bias", "make_weights"),
                       ("MVDeTr", "calibrate_running_stats"), ("warp_coords", "calibrate_running_stats"),
                       ("MVDeTr", "reference_answers"), ("warp_coords", "reference_answers")}}[kind]
    assert set(stubbed) == sites
    assert out["correct"] is True, out["checks"]
    # the stub delegates to ``model``, the default: the same numbers as a run that names no reference
    assert out["numbers"] == _run(config("windowed"), kind, 31)["numbers"]


def test_a_named_reference_is_counted(stubbed):
    cfg = dict(config("windowed"), reference=STUB)
    count = flops.count_flops(cfg, inputs.rig_of(cfg), 2, True)
    assert stubbed == [("MVDeTr", "count_flops")]
    assert count == flops.count_flops(config("windowed"), inputs.rig_of(cfg), 2, True)


@pytest.mark.parametrize("name", ["model.x", "reference.model", "../model", "reference/model", "model/", "", 3])
def test_a_name_that_is_not_an_identifier_is_refused(name):
    with pytest.raises(ValueError):
        reference.of({"reference": name})


def test_the_default_is_model():
    assert reference.of({}) is model
    cfg = config("windowed")
    rig = inputs.rig_of(cfg)
    named = inputs.make_weights(dict(cfg, reference="model"), rig, 7, CPU)
    plain = inputs.make_weights(cfg, rig, 7, CPU)
    assert named.keys() == plain.keys() and all(torch.equal(named[k], plain[k]) for k in plain)


def _digest(tensors: dict) -> str:
    m = hashlib.sha256()
    for k in sorted(tensors):
        m.update(k.encode())
        m.update(np.ascontiguousarray(tensors[k].numpy()).tobytes())
    return m.hexdigest()[:16]


# Written in from the code before configurations named their reference: what
# the benchmark reads of both configurations, which name none.
FULL = {"windowed": {"flops_train": 15_209_585_049_600, "flops_serve": 2_542_889_779_200,
                     "attention_train": 0.0012974467915548647, "attention_serve": 0.00017580077371685555,
                     "b3": 6.306770149253731e-05},
        "gather": {"flops_train": 15_209_585_049_600, "flops_serve": 2_542_889_779_200,
                   "attention_train": 0.0012974467915548647, "attention_serve": 0.00017580077371685555,
                   "b3": 0.0013109416119402985}}
TINY = {"windowed": {"weights": "1e41df981193312f", "losses": (4.627429962158203, 4.633142471313477, 4.323093891143799)},
        "gather": {"weights": "1e41df981193312f", "losses": (4.623947620391846, 4.623234748840332, 4.318127632141113)}}


@pytest.mark.parametrize("mode", MODES)
def test_full_counts_and_least_times_as_before(mode):
    cfg = load("configs", f"wildtrack_{mode}.json")
    assert "reference" not in cfg
    rig, want, formula = inputs.rig_of(cfg), FULL[mode], flops.attention_formula(cfg)
    assert flops.count_flops(cfg, rig, 2, True) == want["flops_train"]
    assert flops.count_flops(cfg, rig, 1, False) == want["flops_serve"]
    assert formula.least_step_seconds(cfg, 2, True) == want["attention_train"]
    assert formula.least_step_seconds(cfg, 1, False) == want["attention_serve"]
    assert flops.b3_least_seconds(cfg, 2) == want["b3"]


@pytest.mark.parametrize("mode", MODES)
def test_weights_and_reference_losses_as_before(mode):
    cfg = config(mode)
    rig = inputs.rig_of(cfg)
    assert _digest(inputs.make_weights(cfg, rig, 11, CPU)) == TINY[mode]["weights"]  # bitwise, same draw order
    seeds, traffic = inputs.Seeds(5), train_traffic()
    pool = inputs.train_pool(cfg, traffic, rig, seeds, CPU)[:traffic["warmup_steps"]]
    ref = check.reference_train(cfg, rig, inputs.make_weights(cfg, rig, seeds.weights, CPU), pool, seeds.dropout,
                                cells.total_steps(cfg, traffic), CPU)
    assert ref["loss"] == pytest.approx(TINY[mode]["losses"], rel=1e-6)
