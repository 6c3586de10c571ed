"""The program's profiler spans (``utils/profiling.py::span``): under a
profiler, a tiny model's ``train_step`` and ``eval_step`` mark their phases
with ``mvdetr:*`` annotations, nested as the program nests them, and
``device_trace`` writes them to its trace; with no profiler running, no span
makes a ``record_function``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.deformable import MSDeformAttn
from mvdetr_tpu_torch.models.layers import BatchNorm2d, LayerNorm
from mvdetr_tpu_torch.train import create_train_state, eval_step, train_step
from mvdetr_tpu_torch.utils.profiling import device_trace
from _torch_port import few_torch_threads, inside, spans_of, synthetic_train_batch  # noqa: F401

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, IMG_REDUCE = 2, 12


@pytest.fixture(scope="module")
def tiny(few_torch_threads):  # noqa: F811
    rig = make_synthetic_rig(**RIG)
    model = MVDeTr.from_rig(rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, device="cpu")
    state = create_train_state(model, lr=5e-4, total_steps=10)
    batch = synthetic_train_batch(rig, 1, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, seed=0)
    return state, batch


def take_step(kind, tiny):
    state, batch = tiny
    if kind == "train":
        train_step(state, batch, torch.Generator().manual_seed(0), device="cpu")
    else:
        eval_step(state.model, {k: batch[k] for k in ("imgs", "affine_mats")}, world_reduce=WORLD_REDUCE,
                  num_candidates=32, device="cpu")


def test_train_step_spans_nest(tiny, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        take_step("train", tiny)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = spans_of(tmp_path / "trace.json")
    model = tiny[0].model
    assert len(spans["train_step"]) == 1
    for name, count in (("upload", 1), ("train.forward", 1), ("train.backward", 1), ("train.optimizer", 2)):
        assert len(spans[name]) == count and all(inside(s, spans["train_step"]) for s in spans[name]), name
    for name in ("trunk", "warp", "attention", "norm"):
        assert all(inside(s, spans["train.forward"]) for s in spans[name]), name
    assert len(spans["trunk"]) == len(spans["warp"]) == 1
    assert len(spans["attention"]) == sum(isinstance(m, MSDeformAttn) for m in model.modules())
    assert len(spans["norm"]) == sum(isinstance(m, (BatchNorm2d, LayerNorm)) for m in model.modules())
    bns = sum(isinstance(m, BatchNorm2d) for m in model.base.modules())
    assert bns > 0 and sum(inside(s, spans["trunk"]) for s in spans["norm"]) == bns
    # no span opens inside a backward pass
    assert not any(inside(s, spans["train.backward"]) for name, ss in spans.items() if name != "train.backward"
                   for s in ss)


def test_eval_step_spans_nest_in_device_trace(tiny, tmp_path):
    """``device_trace`` taken around an ``eval_step`` writes the spans of a
    request into ``trace.json`` and its table into ``kernels.txt`` (the
    CLI's ``--profile`` traces training steps only)."""
    with device_trace(str(tmp_path)):
        take_step("eval", tiny)
    assert (tmp_path / "kernels.txt").read_text()
    spans = spans_of(tmp_path / "trace.json")
    assert len(spans["eval_step"]) == 1
    for name in ("upload", "trunk", "norm", "warp", "attention", "decode", "nms"):
        assert spans[name] and all(inside(s, spans["eval_step"]) for s in spans[name]), name
    assert any(inside(s, spans["trunk"]) for s in spans["norm"])
    assert not any(name.startswith("train") for name in spans)


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_no_record_function_without_a_profiler(kind, tiny, monkeypatch):
    """``span`` enters ``torch.profiler.record_function`` only while a
    profiler runs; the counting patch sees that call under one."""
    made = []
    real = torch.profiler.record_function

    def counting(*args, **kwargs):
        made.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    take_step(kind, tiny)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        take_step(kind, tiny)
    assert f"mvdetr:{kind}_step" in made and "mvdetr:attention" in made
