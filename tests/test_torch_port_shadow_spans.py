"""The shadow warp's span and counter (``ops/msda_warped.py``): under a
profiler, a tiny 8-point model's ``train_step`` marks each encoder layer's
resample of the value at the shadow maps as ``mvdetr:shadow_warp`` inside
that layer's ``mvdetr:attention``, and ``shadow_warp_stack.calls`` rises by
one a layer and forward, with or without a profiler."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.deformable import MSDeformAttn
from mvdetr_tpu_torch.ops.msda_warped import shadow_warp_stack
from mvdetr_tpu_torch.train import create_train_state, eval_step, train_step
from _torch_port import few_torch_threads, inside, spans_of, synthetic_train_batch  # noqa: F401

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, IMG_REDUCE = 2, 12


@pytest.fixture(scope="module")
def tiny(few_torch_threads):  # noqa: F811
    rig = make_synthetic_rig(**RIG)
    model = MVDeTr.from_rig(rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, n_points=8, device="cpu")
    state = create_train_state(model, lr=5e-4, total_steps=10)
    batch = synthetic_train_batch(rig, 1, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, seed=0)
    layers = [m for m in model.modules() if isinstance(m, MSDeformAttn)]
    assert layers and all(m.mode == "warped" for m in layers)
    return state, batch, len(layers)


def test_train_step_marks_each_shadow_warp_inside_its_attention(tiny, tmp_path):
    state, batch, layers = tiny
    before = shadow_warp_stack.calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch, torch.Generator().manual_seed(0), device="cpu")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = spans_of(tmp_path / "trace.json")
    assert shadow_warp_stack.calls - before == layers
    assert len(spans["shadow_warp"]) == len(spans["attention"]) == layers
    for s in spans["shadow_warp"]:
        assert inside(s, spans["attention"]) and inside(s, spans["train.forward"])
    # one warp a layer: each attention span holds exactly one
    assert all(sum(inside(s, [a]) for s in spans["shadow_warp"]) == 1 for a in spans["attention"])


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_calls_counted_without_a_profiler(tiny, kind):
    state, batch, layers = tiny
    before = shadow_warp_stack.calls
    if kind == "train":
        train_step(state, batch, torch.Generator().manual_seed(1), device="cpu")
    else:
        eval_step(state.model, {k: batch[k] for k in ("imgs", "affine_mats")}, world_reduce=WORLD_REDUCE,
                  num_candidates=32, device="cpu")
    assert shadow_warp_stack.calls - before == layers
