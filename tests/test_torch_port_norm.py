"""BatchNorm2d's plain versions and its kernels' wrapper (``ops/batch_norm.py``)
on the CPU: the closed-form backward that ``csrc/batch_norm.cu`` computes,
held against autograd through the plain forward; the wrapper's refusals; the
channels-last dense tensors and the loads it hands the kernels; the trunk's
shapes. The kernels themselves
run in ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from chip_smoke import TRUNK_NORM_SHAPES
from mvdetr_tpu_torch.models.layers import BatchNorm2d, frozen_running_stats
from mvdetr_tpu_torch.models.resnet import resnet_features
from mvdetr_tpu_torch.ops import batch_norm as bn
from _torch_port import few_torch_threads  # noqa: F401

EPS = 1e-5
MODES = {"train": (True, True), "eval": (False, False), "freeze": (True, False)}  # (training, update_stats)
# largest gap of the closed form from autograd, of max|autograd|: in f64 the two differ by the order of their
# f64 roundings; in f32 by f32 sums of 72 terms a channel taken in another order and dx's three terms added in
# another grouping (autograd sums the mean's, the square's and the affine's paths into x's gradient)
GAP = {torch.float64: 1e-12, torch.float32: 2e-6}


def _inputs(dtype, channels_last, seed=0, shape=(3, 5, 4, 6)):
    """x with its own mean and scale a channel, dy, weights and running
    statistics, all from ``seed``."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    x = rng.standard_normal(shape) * rng.uniform(0.5, 2.0, (1, c, 1, 1)) + rng.uniform(-1.0, 1.0, (1, c, 1, 1))
    x = torch.from_numpy(x).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    vectors = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.uniform(-0.5, 0.5, c),
               "running_mean": rng.uniform(-0.5, 0.5, c), "running_var": rng.uniform(0.5, 2.0, c)}
    return x, dy, {k: torch.from_numpy(v).to(dtype) for k, v in vectors.items()}


def _autograd(x, dy, v, training, update_stats):
    """The plain forward's output, its gradients by autograd and its running
    statistics after the call."""
    x = x.clone().requires_grad_()
    weight, bias = v["weight"].clone().requires_grad_(), v["bias"].clone().requires_grad_()
    run_mean, run_var, count = v["running_mean"].clone(), v["running_var"].clone(), torch.zeros((), dtype=torch.long)
    y = bn.batch_norm_plain(x, weight, bias, run_mean, run_var, count, training, update_stats, EPS, x.dtype)
    y.backward(dy)
    return y.detach(), (x.grad, weight.grad, bias.grad), (run_mean, run_var, int(count))


def _stats(x, v, training):
    dims = (0, 2, 3)
    if training:
        return torch.stack([x.mean(dim=dims), (x * x).mean(dim=dims)])
    return torch.stack([v["running_mean"], v["running_var"]])


def _assert_grads(ours, ref, dtype):
    for name, a, b in zip(("dx", "dweight", "dbias"), ours, ref):
        assert a.dtype == b.dtype, name
        gap = float((a - b).abs().max() / b.abs().max())
        assert gap <= GAP[dtype], f"{name}: {gap}"


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_closed_form_backward_matches_autograd(dtype, channels_last, mode, few_torch_threads):  # noqa: F811
    """dx, dweight and dbias of ``batch_norm_bwd_plain`` against autograd
    through ``batch_norm_plain``; freeze takes the batch statistics and
    leaves the running ones (and the count) as they were."""
    training, update_stats = MODES[mode]
    x, dy, v = _inputs(dtype, channels_last)
    _, ref, (run_mean, run_var, count) = _autograd(x, dy, v, training, update_stats)
    ours = bn.batch_norm_bwd_plain(x, dy, _stats(x, v, training), v["weight"], EPS, training)
    _assert_grads(ours, ref, dtype)
    moved = mode == "train"
    assert count == int(moved)
    assert torch.equal(run_mean, v["running_mean"]) != moved and torch.equal(run_var, v["running_var"]) != moved


def _with_constant_channel(x, v, negative):
    """x with channel 0 constant at a value whose one-pass variance, as the
    statistics take it, is below 0 (the clamp active) or exactly 0 (the
    clamp passes the gradient)."""
    for value in ([0.01 + 0.0137 * k for k in range(1, 200)] if negative else [0.5]):
        x = x.clone()
        x[:, 0] = value
        stats = _stats(x, v, True)
        gap = float(stats[1, 0] - stats[0, 0] * stats[0, 0])
        if (gap < 0) if negative else (gap == 0):
            return x, stats
    raise AssertionError(f"no constant with a {'negative' if negative else 'zero'} one-pass variance in {x.dtype}")


@pytest.mark.parametrize("negative", [True, False], ids=["clamp_active", "clamp_at_zero"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_closed_form_backward_at_a_constant_channel(dtype, negative, few_torch_threads):  # noqa: F811
    """Channel 0 constant: where its one-pass variance rounds below 0 the
    clamp stops the gradient through E[x^2] (dE2 = 0), where it is exactly
    0 the gradient passes, as ``torch.clamp``'s does; the closed form
    follows autograd in both."""
    x, dy, v = _inputs(dtype, channels_last=True, seed=1)
    x, stats = _with_constant_channel(x, v, negative)
    _, ref, _ = _autograd(x, dy, v, True, True)
    _assert_grads(bn.batch_norm_bwd_plain(x, dy, stats, v["weight"], EPS, True), ref, dtype)


def test_closed_form_backward_in_bf16_rounds_dx_once(few_torch_threads):  # noqa: F811
    """A bf16 x: the closed form works in f32 and rounds dx once to bf16,
    as autograd's cast back does; both round the same f32 value, so a tie
    may land one bf16 step apart (2^-8 of the value)."""
    x, dy, v = _inputs(torch.float32, channels_last=True, seed=2)
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    v = {k: t.float() for k, t in v.items()}
    _, ref, _ = _autograd(x, dy, v, True, True)
    dx, dweight, dbias = bn.batch_norm_bwd_plain(x, dy, _stats(x.float(), v, True), v["weight"], EPS, True)
    assert dx.dtype == torch.bfloat16 and dweight.dtype == dbias.dtype == torch.float32
    torch.testing.assert_close(dx.float(), ref[0].float(), rtol=2.0**-7, atol=1e-3 * float(ref[0].abs().max()))
    _assert_grads((dweight, dbias), ref[1:], torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_module_on_the_cpu_is_the_plain_function(dtype, few_torch_threads):  # noqa: F811
    """``BatchNorm2d`` on a CPU tensor is ``batch_norm_plain``, bit for bit,
    forward, backward and running statistics; no kernel is counted."""
    x, dy, v = _inputs(torch.float32, channels_last=True, seed=3)
    x = x.to(dtype)
    module = BatchNorm2d(x.shape[1], dtype).train()
    with torch.no_grad():
        for name, t in v.items():
            getattr(module, name).copy_(t.float())
    launches = (bn.batch_norm.launches, bn.batch_norm_bwd.launches)
    xm = x.clone().requires_grad_()
    y = module(xm)
    y.backward(dy.to(dtype))
    ref_y, ref_grads, (run_mean, run_var, count) = _autograd(x, dy.to(dtype), {k: t.float() for k, t in v.items()},
                                                             True, True)
    assert torch.equal(y, ref_y) and torch.equal(xm.grad, ref_grads[0])
    assert torch.equal(module.weight.grad, ref_grads[1]) and torch.equal(module.bias.grad, ref_grads[2])
    assert torch.equal(module.running_mean, run_mean) and torch.equal(module.running_var, run_var)
    assert int(module.num_batches_tracked) == count == 1
    with frozen_running_stats(module):
        module(x)
    assert int(module.num_batches_tracked) == 1
    assert (bn.batch_norm.launches, bn.batch_norm_bwd.launches) == launches


def test_module_runs_on_the_meta_device():
    """The benchmark counts the model's FLOPs on the meta device: there the
    module takes the plain function, forward and backward."""
    with torch.device("meta"):
        module = BatchNorm2d(8, torch.bfloat16).train()
        x = torch.empty(2, 8, 5, 6, dtype=torch.bfloat16).requires_grad_()
        y = module(x)
        y.float().sum().backward()
    assert y.device.type == "meta" and y.dtype == torch.bfloat16 and x.grad.shape == x.shape


@pytest.mark.parametrize("case", ["rank", "dtype", "out_dtype", "channels", "empty", "wide", "device"])
def test_wrapper_refusals(case):
    """The kernels' wrappers raise ValueError, before any launch, on what
    the kernels do not take: a tensor not [N, C, H, W], a dtype other than
    f32 and bf16 (x, the output, dy), C unlike the weights', an empty map,
    more channels than a block's loads cover, and a tensor that is not on a
    CUDA device."""
    x, dy, v = _inputs(torch.float32, channels_last=True)
    dtype, match = torch.float32, None
    if case == "rank":
        x, match = x[0], r"\[N, C, H, W\]"
    elif case == "dtype":
        x, match = x.double(), "f32 or bf16"
    elif case == "out_dtype":
        dtype, match = torch.float16, "f32 or bf16"
    elif case == "channels":
        x, match = x[:, :4], "channels"
    elif case == "empty":
        x, match = x[:0], "empty"
    elif case == "wide":  # 1100 f32 channels, 4 a load: 275 threads a row
        x, match = torch.zeros(2, 1100, 1, 1), "do not fit a block"
        v = {k: torch.zeros(1100) for k in v}
    else:
        match = "CUDA device only"
    launches = (bn.batch_norm.launches, bn.batch_norm_bwd.launches)
    with pytest.raises(ValueError, match=match):
        bn.batch_norm(x, v["weight"], v["bias"], v["running_mean"], v["running_var"], torch.zeros((), dtype=torch.long),
                      training=True, update_stats=True, eps=EPS, dtype=dtype)
    if case != "out_dtype":
        with pytest.raises(ValueError, match=match):
            bn.batch_norm_bwd(x, x, torch.zeros(2, 5), v["weight"], eps=EPS, training=True)
    with pytest.raises(ValueError, match="unlike x"):
        bn.batch_norm_bwd(x[:1], dy, torch.zeros(2, 5), v["weight"], eps=EPS, training=True)
    assert (bn.batch_norm.launches, bn.batch_norm_bwd.launches) == launches


def _view(shape, dtype, channels_last, shift=0):
    """A dense tensor of ``shape``, ``shift`` elements into its storage."""
    n, c, h, w = shape
    flat = torch.arange(n * c * h * w + shift).to(dtype)[shift:]
    if channels_last:
        return flat.view(n, h, w, c).permute(0, 3, 1, 2)
    return flat.view(shape)


@pytest.mark.parametrize("shape,dtype,channels_last,shift,vec,copied", [
    ((1, 64, 4, 4), torch.bfloat16, True, 0, 8, False),  # the trunk's C: 8 channels a 16-byte load, no copy
    ((1, 512, 4, 4), torch.float32, True, 0, 4, False),
    ((2, 64, 5, 6), torch.bfloat16, True, 1, 8, True),  # one element into the storage: copied to aligned storage
    ((2, 12, 5, 6), torch.bfloat16, True, 0, 1, False),  # C no multiple of 8: one a load
    ((2, 2048, 3, 3), torch.bfloat16, True, 0, 8, False),  # 256 threads a row
    ((2, 4096, 3, 3), torch.bfloat16, True, 0, None, False),  # wider than a block: refused
    ((2, 300, 4, 4), torch.bfloat16, True, 0, None, False),  # one a load, 300 > 256 threads: refused
    ((2, 64, 8, 10), torch.float32, False, 0, 4, True),  # NCHW: made channels-last
    ((2, 64, 5, 6), torch.bfloat16, False, 0, 8, True),
])
def test_body_follows_the_strides(shape, dtype, channels_last, shift, vec, copied):
    """What the kernels get from what the input shows: a channels-last
    dense, 16-byte aligned tensor as it is, any other as a channels-last
    copy with the same values; 16 bytes of channels a load where C allows,
    else one, and no C wider than a block's loads."""
    x = _view(shape, dtype, channels_last, shift)
    dense = bn.rows_dense(x)
    assert dense.is_contiguous(memory_format=torch.channels_last) and dense.data_ptr() % 16 == 0
    assert (dense.data_ptr() != x.data_ptr()) == copied and torch.equal(dense, x)
    assert bn.row_vec(shape[1], x.element_size()) == vec


def test_body_makes_other_strides_dense_and_pairs_dy_with_x():
    """A strided view is copied channels-last; a map of one pixel is the
    same rows in either format and is taken as it is."""
    x = torch.arange(2 * 64 * 10 * 16, dtype=torch.float32).view(2, 64, 10, 16)[:, :, ::2]
    dense = bn.rows_dense(x)
    assert dense.is_contiguous(memory_format=torch.channels_last) and torch.equal(dense, x)
    x = torch.zeros(4, 64, 1, 1, dtype=torch.bfloat16)
    assert bn.rows_dense(x).data_ptr() == x.data_ptr()


def test_plan_at_the_trunk_shapes():
    """At every trunk shape the reductions take 4 slabs and the elementwise
    passes 8 blocks a multiprocessor (132 on an H100), fewer only where the
    map has fewer block passes of rows."""
    for c, h, w in TRUNK_NORM_SHAPES:
        assert bn.plan(8, 14 * h * w, c, 132) == bn.Plan(8, 528, 1056), (c, h, w)
    assert bn.plan(8, 16, 64, 132) == bn.Plan(8, 1, 1)  # 32 rows a pass
    assert bn.plan(1, 100, 12, 132) == bn.Plan(1, 5, 5)  # 21 rows of 12 channels a pass


def test_trunk_norm_shapes_are_the_trunks():
    """``chip_smoke.TRUNK_NORM_SHAPES``, the shapes the card tests and the
    timing phase run at, are the inputs of the dilated ResNet-18's 20
    BatchNorms at the cells' 720x1280 frames, in forward order: 94.0 M
    elements a camera."""
    with torch.device("meta"):
        trunk = resnet_features(dtype=torch.bfloat16).eval()
        seen = []
        for m in trunk.modules():
            if isinstance(m, BatchNorm2d):
                m.register_forward_pre_hook(lambda _m, args: seen.append(tuple(args[0].shape[1:])))
        trunk(torch.empty(1, 3, 720, 1280, dtype=torch.bfloat16))
    assert seen == list(TRUNK_NORM_SHAPES)
    assert sum(c * h * w for c, h, w in seen) == 94_003_200
