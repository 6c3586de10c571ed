"""The training slice against the JAX package: BatchNorm in training mode
against Flax, the seeded dropouts, the two-group Adam and OneCycle schedule
against optax, and the gate: one ``train_step`` from the same carried-over
weights and batch against ``mvdetr_tpu.train.train_step``, in f32 and bf16,
and the loss of ``eval_step``.

The batch comes from ``_torch_port.synthetic_train_batch`` (the port's
``build_targets``) on the 3-camera rig of ``test_torch_port_model.py``. The
JAX model's offset and attention-weight kernels get seeded noise, so offsets
are not integers: at an integer offset the JAX CPU path (autodiff of the XLA
op) and the port (the TPU kernel's convention) differ by design (see
``test_torch_port_msda_bwd.py``). Dropout RNG cannot match across frameworks,
so the gate runs without dropout: the JAX encoder's rate (fixed at 0.1 and not
exposed) is set to 0 inside the test, the port passes ``encoder_dropout=0``.

Tolerances. The gradients of the trunk are ill-conditioned at this size:
BatchNorm's backward over a few hundred positions per channel cancels most
of its terms, so f32 rounding shows up amplified. Measured on this fixture,
JAX's own f32 gradients differ from a float64 JAX run by up to 5.6e-2 of a
trunk leaf's largest entry (1e-3 outside the trunk), and the port's by as
much. So, in f32: the loss to 1e-5 relative; every gradient leaf to 1e-2 in
relative L2 norm (observed at most 5e-3, median 2.6e-4); the largest entry
error to 1e-2 of the leaf's largest entry outside the trunk and 1e-1 in it;
BatchNorm running statistics to 1e-5 of scale. Adam's first step moves each
entry by about ``lr * sign(g)``, so an entry whose gradient sits at that
noise may move the other way: every entry within 2 lr of the JAX step (plus
the f32 rounding of the parameter on each side), and
in each leaf at most 1% of the entries more than lr / 2 from it. In bf16 the
trunk's gradients are mostly rounding noise on both sides (observed cosine
0.88-1.0 between them): the loss and statistics to 4e-2 of scale (the model
test's bound), every gradient leaf at cosine >= 0.8 and the leaves outside
the trunk to 0.4 in relative L2 norm (observed at most 0.29)."""

import functools

import numpy as np
import optax
import pytest
import torch
import torch.nn as tnn

import flax.linen as fnn
import jax
import jax.numpy as jnp

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.interop import convert_reference_state_dict
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.models.world_feat import modules as jax_world_feat_modules
from mvdetr_tpu.train import create_train_state as jax_create_train_state
from mvdetr_tpu.train import eval_step as jax_eval_step
from mvdetr_tpu.train import train_step as jax_train_step
from mvdetr_tpu.train.optim import build_optimizer as jax_build_optimizer
from mvdetr_tpu.train.optim import onecycle_b1_schedule, onecycle_lr_schedule
from mvdetr_tpu.train.trainer import supervised_loss as jax_supervised_loss
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.layers import BatchNorm2d, Dropout, set_dropout_generator
from mvdetr_tpu_torch.train import create_train_state, eval_step, train_step
from mvdetr_tpu_torch.train.optim import build_optimizer, schedule_step
from _torch_port import synthetic_train_batch

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, IMG_REDUCE = 2, 12
LR, TOTAL_STEPS = 5e-4, 100
LOSS_KEYS = ("loss", "w_hm", "w_off", "img_hm", "img_off", "img_wh")


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_matches_flax(dtype, rng):
    """Batch statistics over (N, H, W) with the one-pass variance, f32
    normalisation rounded once, momentum-0.9 running update with the biased
    variance; and, in f32, the gradients through the batch statistics."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (None, torch.float32)
    x = rng.normal(1.5, 2.0, (4, 7, 9, 16)).astype(np.float32)  # NHWC
    x = np.array(jnp.asarray(x).astype(jd or jnp.float32).astype(jnp.float32))  # same values on both sides
    scale, bias = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.normal(0, 0.3, 16).astype(np.float32)
    mean0, var0 = rng.normal(0, 0.5, 16).astype(np.float32), rng.uniform(0.5, 2, 16).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jd)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def f(params, x):
        y, mutated = bn.apply({"params": params, "batch_stats": stats}, x.astype(jd or jnp.float32),
                              mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, mutated["batch_stats"])

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    (_, (ref, ref_stats)), (g_params, g_x) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    port = BatchNorm2d(16, dtype=td).train()
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean0), ("running_var", var0)):
            getattr(port, name).copy_(torch.from_numpy(v))
    tx = torch.from_numpy(x).to(td).permute(0, 3, 1, 2).requires_grad_()
    y = port(tx)
    (y.float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert y.dtype == td and int(port.num_batches_tracked) == 1
    ours = y.float().permute(0, 2, 3, 1).detach().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "bfloat16":  # both sides round the same f32 value once: a tie may round one step apart
        np.testing.assert_allclose(ours, ref, rtol=2.0**-7, atol=1e-6)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_x), rtol=0, atol=1e-4)
        np.testing.assert_allclose(port.weight.grad.numpy(), np.asarray(g_params["scale"]), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(g_params["bias"]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(ref_stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(ref_stats["var"]), rtol=1e-6, atol=1e-6)


def test_dropout_zeroes_whole_channels_scales_kept_values_and_repeats_from_a_seed():
    x = torch.rand(8, 64, 5, 6) + 0.5
    drop = Dropout(0.25, channels=True).train()
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    set_dropout_generator(drop, torch.Generator().manual_seed(3))
    y = drop(x)
    kept = (y != 0).flatten(2)
    assert (kept.all(-1) | (~kept).all(-1)).all()  # a channel is kept or dropped whole
    assert 0.1 < float((~kept.all(-1)).float().mean()) < 0.4
    torch.testing.assert_close(y[y != 0], (x / 0.75)[y != 0], rtol=0, atol=0)
    set_dropout_generator(drop, torch.Generator().manual_seed(3))
    torch.testing.assert_close(drop(x), y, rtol=0, atol=0)  # same seed, same mask
    assert not torch.equal(drop(x), y)  # the generator moves on
    assert drop.eval()(x) is x and Dropout(0.0).train()(x) is x


def test_dropout_elementwise_rate_and_scale():
    x = torch.ones(200, 300)
    drop = Dropout(0.1).train()
    set_dropout_generator(drop, torch.Generator().manual_seed(0))
    y = drop(x)
    assert abs(float((y == 0).float().mean()) - 0.1) < 0.005
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9), rtol=0, atol=0)


# ---------------------------------------------------------------- optimizer
class _Tiny(tnn.Module):
    def __init__(self):
        super().__init__()
        self.base = tnn.Linear(5, 4)
        self.head = tnn.Linear(4, 3)


def test_adam_and_onecycle_match_optax(rng):
    """Two groups (``base`` at lr * 0.1), coupled weight decay, OneCycle
    learning rate and beta1, step by step for 100 steps and 10 beyond (the
    schedules hold their last value), on the same random gradients."""
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    names = [n for n, _ in model.named_parameters()]
    jparams = {"base": {"weight": None, "bias": None}, "head": {"weight": None, "bias": None}}
    for n, p in model.named_parameters():
        top, leaf = n.split(".")
        jparams[top][leaf] = jnp.asarray(p.detach().numpy().copy())  # jnp may alias numpy memory
    tx = jax_build_optimizer(jparams, LR, TOTAL_STEPS, base_lr_ratio=0.1, weight_decay=1e-4)
    opt_state = tx.init(jparams)
    optimizer, scheduler = build_optimizer(model, LR, TOTAL_STEPS, base_lr_ratio=0.1, weight_decay=1e-4)
    lr_other, lr_base = onecycle_lr_schedule(LR, TOTAL_STEPS), onecycle_lr_schedule(LR * 0.1, TOTAL_STEPS)
    b1 = onecycle_b1_schedule(TOTAL_STEPS)
    for step in range(TOTAL_STEPS + 10):
        base, other = optimizer.param_groups
        # the JAX schedule is evaluated in f32: 1 + cos(.) cancels near the end of the cycle
        np.testing.assert_allclose([base["lr"], other["lr"]], [float(lr_base(step)), float(lr_other(step))],
                                   rtol=1e-5, atol=1e-7 * LR)
        np.testing.assert_allclose([base["betas"][0], other["betas"][0]], float(b1(step)), rtol=1e-6)
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        optimizer.step()
        schedule_step(scheduler)
        jgrads = {"base": {}, "head": {}}
        for n in names:
            top, leaf = n.split(".")
            jgrads[top][leaf] = jnp.asarray(grads[n])
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in model.named_parameters():
            top, leaf = n.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[top][leaf]), rtol=0, atol=2e-6,
                                       err_msg=f"{n} at step {step}")


# ---------------------------------------------------------------- the gate
def _perturb(variables, seed=0):
    """Seeded noise on the zero-initialised offset and attention-weight
    kernels (offsets then vary per query, are not integers and some bind the
    clamp), and on the norm scales."""
    r = np.random.default_rng(seed)

    def f(path, x):
        key = jax.tree_util.keystr(path)
        x = np.array(x)
        if ("sampling_offsets" in key or "attention_weights" in key) and "kernel" in key:
            return x + r.normal(0, 0.05, x.shape).astype(np.float32)
        if key.endswith("['scale']"):
            return r.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, variables)


def _jax_grads(state, batch, rng):
    """The gradients inside ``mvdetr_tpu.train.train_step`` (its loss_fn)."""
    def loss_fn(params):
        outputs, mutated = state.apply_fn({"params": params, "batch_stats": state.batch_stats}, batch["imgs"],
                                          batch["affine_mats"], train=True, mutable=["batch_stats", "diagnostics"],
                                          rngs={"dropout": rng})
        return jax_supervised_loss(outputs, batch)[0]

    return jax.jit(jax.grad(loss_fn))(state.params)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _as_jax_tree(model, tensors=None):
    """The port's parameters (or ``tensors`` by parameter name, e.g. the
    gradients) with its buffers, in the JAX package's variable tree."""
    sd = {k: v.detach().float() for k, v in model.state_dict().items()}
    sd.update({k: v.detach().float() for k, v in (tensors or {}).items()})
    # copies: jnp arrays may alias numpy memory, and the step updates the parameters in place
    return convert_reference_state_dict({k: v.numpy().copy() for k, v in sd.items()})


@pytest.fixture(scope="module")
def gate():
    jax_rig, rig = jax_make_rig(**RIG), make_synthetic_rig(**RIG)
    batch = synthetic_train_batch(rig, 2, WORLD_REDUCE, IMG_REDUCE, seed=5)
    jbatch = jax.tree.map(jnp.asarray, batch)
    results = {}
    no_dropout = functools.partial(jax_world_feat_modules.DeformTransWorldFeat, dropout=0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_world_feat_modules, "DeformTransWorldFeat", no_dropout)
        for dtype, jd, td in (("float32", None, None), ("bfloat16", jnp.bfloat16, torch.bfloat16)):
            jm = JaxMVDeTr.from_rig(jax_rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, compute_dtype=jd)
            state = jax_create_train_state(jm, batch, lr=LR, total_steps=TOTAL_STEPS)
            var = _perturb({"params": state.params, "batch_stats": state.batch_stats})
            state = state.replace(params=var["params"], batch_stats=var["batch_stats"])
            key = jax.random.PRNGKey(0)
            grads = _jax_grads(state, jbatch, key)
            new_state, aux = jax_train_step(jax.tree.map(jnp.copy, state), jbatch, key)
            jeval = jax_eval_step(state, jbatch, world_reduce=WORLD_REDUCE, num_candidates=32)[0]

            port = MVDeTr.from_rig(rig, world_reduce=WORLD_REDUCE, img_reduce=IMG_REDUCE, compute_dtype=td,
                                   encoder_dropout=0.0, device="cpu")
            port.load_state_dict(from_jax_variables(var, device="cpu"))
            before = _as_jax_tree(port)
            peval = eval_step(port, batch, world_reduce=WORLD_REDUCE, num_candidates=32, device="cpu")[0]
            pstate = create_train_state(port, lr=LR, total_steps=TOTAL_STEPS)
            pstate, paux = train_step(pstate, batch, torch.Generator().manual_seed(0), device="cpu")
            results[dtype] = dict(
                jax_aux={k: float(v) for k, v in aux.items()}, port_aux={k: float(v) for k, v in paux.items()},
                jax_grads=_flat(grads),
                port_grads=_flat(_as_jax_tree(port, {n: p.grad for n, p in port.named_parameters()})["params"]),
                before=_flat(before["params"]), jax_params=_flat(new_state.params),
                port_params=_flat(_as_jax_tree(port)["params"]),
                jax_stats=_flat(new_state.batch_stats), port_stats=_flat(_as_jax_tree(port)["batch_stats"]),
                jax_eval={k: float(v) for k, v in jeval.items()}, port_eval={k: float(v) for k, v in peval.items()},
                step=pstate.step,
            )
    return results


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_loss_matches_jax(gate, dtype):
    r = gate[dtype]
    rel = 1e-5 if dtype == "float32" else 4e-2
    for k in (*LOSS_KEYS, "offset_clip_fraction"):
        np.testing.assert_allclose(r["port_aux"][k], r["jax_aux"][k], rtol=rel, atol=1e-7 if k != "loss" else 0,
                                   err_msg=k)
    assert 0 < r["jax_aux"]["offset_clip_fraction"] < 1 and r["step"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_gradients_match_jax(gate, dtype):
    r = gate[dtype]
    assert r["port_grads"].keys() == r["jax_grads"].keys()
    bad = {}
    for k, ref in r["jax_grads"].items():
        ours, trunk = r["port_grads"][k], k.startswith("['base']")
        rel_l2 = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
        if dtype == "float32":
            rel_max = np.abs(ours - ref).max() / np.abs(ref).max()
            if rel_l2 > 1e-2 or rel_max > (1e-1 if trunk else 1e-2):
                bad[k] = (rel_l2, rel_max)
        else:
            cos = (ours * ref).sum() / (np.linalg.norm(ours) * np.linalg.norm(ref))
            if cos < 0.8 or (not trunk and rel_l2 > 0.4):
                bad[k] = (rel_l2, cos)
    assert not bad, f"gradient leaves off: {bad}"


def test_train_step_updated_params_and_batch_stats_match_jax(gate):
    r = gate["float32"]
    lr0 = LR / 25.0  # OneCycle's first learning rate
    for k, ref in r["jax_params"].items():
        lr = lr0 * (0.1 if k.startswith("['base']") else 1.0)
        diff = np.abs((r["port_params"][k] - r["before"][k]) - (ref - r["before"][k]))
        assert (diff <= 2 * lr + 4 * np.finfo(np.float32).eps * np.abs(r["before"][k])).all(), k  # each side rounded
        assert (diff > lr / 2).mean() <= 0.01, k
    for k, ref in r["jax_stats"].items():
        np.testing.assert_allclose(r["port_stats"][k], ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=k)


def test_train_step_bf16_batch_stats_match_jax(gate):
    r = gate["bfloat16"]
    for k, ref in r["jax_stats"].items():
        np.testing.assert_allclose(r["port_stats"][k], ref, rtol=0, atol=4e-2 * max(1.0, np.abs(ref).max()),
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_loss_matches_jax(gate, dtype):
    r = gate[dtype]
    rel = 1e-5 if dtype == "float32" else 4e-2
    for k in (*LOSS_KEYS, "offset_clip_fraction"):
        np.testing.assert_allclose(r["port_eval"][k], r["jax_eval"][k], rtol=rel, atol=1e-7, err_msg=k)
