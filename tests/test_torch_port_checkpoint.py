"""Checkpoints and weight loading of the port, on the CPU at a small size:

- save, restore the full state into a fresh one, take one more step: the
  parameters, BatchNorm statistics, optimizer moments, learning rates and
  step are bitwise equal to those of a step taken without stopping (the
  dropout generator comes from ``Trainer.step_generator(step)``, so it is
  the same too);
- a weights-only restore loads parameters and statistics and leaves the
  optimizer fresh;
- ``create_train_state(backbone_variables=)`` maps a torchvision resnet18
  state dict onto ``base.*`` and refuses one that does not match;
- ``load_full_variables`` loads JAX-shaped variables exactly (the weights
  bridge) and refuses a tree of other shapes.
"""

import copy
import types

import numpy as np
import pytest
import torch

from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.train import (
    Trainer, create_train_state, latest_step, load_full_variables, restore_checkpoint, restore_weights,
    save_checkpoint, train_step,
)

from _torch_port import few_torch_threads, synthetic_train_batch  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=2, img_shape=(48, 96), worldgrid_shape=(32, 64))


def _model(seed=0, **kw):
    return MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=2, img_reduce=12, device="cpu", seed=seed, **kw)


def _state(seed=0):
    return create_train_state(_model(seed), lr=1e-3, total_steps=10)


def _batch(seed):
    return synthetic_train_batch(make_synthetic_rig(**RIG), 2, world_reduce=2, img_reduce=12, seed=seed,
                                 num_person=4, top_k=8)


def _gen(step):
    return Trainer(types.SimpleNamespace(model=torch.nn.Linear(1, 1)), None, None, seed=5).step_generator(step)


def _snapshot(state):
    return (copy.deepcopy(state.model.state_dict()), copy.deepcopy(state.optimizer.state_dict()),
            copy.deepcopy(state.scheduler.state_dict()), state.step)


def _assert_equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_trees(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_resumed_step_is_bitwise_equal_to_an_uninterrupted_one(tmp_path):
    state = _state()
    train_step(state, _batch(1), _gen(0), device="cpu")
    assert latest_step(tmp_path / "ckpt") is None
    path = save_checkpoint(str(tmp_path / "ckpt"), state)
    assert path.endswith("/1") and latest_step(str(tmp_path / "ckpt")) == 1

    train_step(state, _batch(2), _gen(1), device="cpu")  # uninterrupted
    fresh = _state(seed=9)  # other weights: everything must come from the file
    restore_checkpoint(str(tmp_path / "ckpt"), fresh)
    assert fresh.step == 1
    train_step(fresh, _batch(2), _gen(1), device="cpu")
    _assert_equal_trees(_snapshot(fresh), _snapshot(state))
    assert [g["lr"] for g in fresh.optimizer.param_groups] == [g["lr"] for g in state.optimizer.param_groups]


def test_weights_only_restore_leaves_the_optimizer_fresh(tmp_path):
    state = _state()
    train_step(state, _batch(1), _gen(0), device="cpu")
    train_step(state, _batch(2), _gen(1), device="cpu")
    save_checkpoint(str(tmp_path), state)
    save_checkpoint(str(tmp_path), state, step=1)  # an older step: the latest is taken by default
    fresh = _state(seed=9)
    restore_weights(str(tmp_path), fresh)
    _assert_equal_trees(fresh.model.state_dict(), state.model.state_dict())
    assert fresh.optimizer.state_dict()["state"] == {} and fresh.step == 0
    assert fresh.scheduler.last_epoch == 0
    with pytest.raises(FileNotFoundError):
        restore_weights(str(tmp_path / "none"), fresh)


def _torchvision_resnet18_state_dict(model, rng):
    """The keys of torchvision's resnet18 (with its fc layer), random values
    of the trunk's shapes."""
    names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4"}
    sd = {}
    for key, value in model.base.state_dict().items():
        head, rest = key.split(".", 1)
        sd[f"{names[head]}.{rest}"] = (torch.tensor(3) if key.endswith("num_batches_tracked")
                                       else torch.from_numpy(rng.standard_normal(value.shape).astype(np.float32)))
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    return sd


def test_backbone_init_from_a_torchvision_state_dict():
    rng = np.random.default_rng(0)
    model = _model()
    sd = _torchvision_resnet18_state_dict(model, rng)
    before = copy.deepcopy(model.state_dict())
    as_numpy = {k: v.numpy() for k, v in sd.items()}  # the .npz of scripts/prepare_backbone.py holds the same
    create_train_state(model, backbone_variables=as_numpy)
    after = model.state_dict()
    assert torch.equal(after["base.0.weight"], sd["conv1.weight"])
    assert torch.equal(after["base.1.running_var"], sd["bn1.running_var"])
    assert torch.equal(after["base.7.1.bn2.bias"], sd["layer4.1.bn2.bias"])
    assert torch.equal(after["base.6.0.downsample.0.weight"], sd["layer3.0.downsample.0.weight"])
    for key in after:  # nothing outside the trunk moved
        if not key.startswith("base."):
            assert torch.equal(after[key], before[key]), key

    sd["layer2.0.conv1.weight"] = torch.zeros(3, 3, 3, 3)
    with pytest.raises(ValueError, match="shapes differ at \\['base.5.0.conv1.weight'\\]"):
        create_train_state(_model(), backbone_variables=sd)
    del sd["layer2.0.conv1.weight"]
    with pytest.raises(ValueError, match="missing \\['base.5.0.conv1.weight'\\]"):
        create_train_state(_model(), backbone_variables=sd)


def _jax_shaped_variables(model):
    """JAX-shaped variables made from the port's own tree, by inverting the
    weights bridge's layout changes (checked below by going through it)."""
    from mvdetr_tpu.interop import convert_reference_state_dict

    return convert_reference_state_dict({k: v.numpy() for k, v in model.state_dict().items()})


def test_load_full_variables_is_exact_and_checks_shapes():
    src = _model(seed=3)
    variables = _jax_shaped_variables(src)
    state = load_full_variables(_state(seed=4), variables)
    bridged = from_jax_variables(variables, device="cpu")
    _assert_equal_trees({k: v for k, v in state.model.state_dict().items() if "num_batches" not in k},
                        {k: v for k, v in bridged.items() if "num_batches" not in k})
    for k, v in src.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(state.model.state_dict()[k], v), k
    variables["params"]["world_heatmap"]["proj"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="world_heatmap.0.bias"):
        load_full_variables(_state(seed=4), variables)
