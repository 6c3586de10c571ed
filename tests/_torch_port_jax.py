"""JAX-side helpers of the ``tests/test_torch_port_*.py`` files that hold a
whole model of the port against the JAX package's: seeded variables, the JAX
loss and gradients of one training step, the port's from the same weights,
and the comparisons. Card-only tests never import this module (the card's
machine has no JAX)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mvdetr_tpu.interop import convert_reference_state_dict
from mvdetr_tpu.train.trainer import supervised_loss as jax_supervised_loss
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.train import create_train_state, train_step

F32_TOL, BF16_TOL = 1e-4, 4e-2
LOSS_KEYS = ("loss", "w_hm", "w_off", "img_hm", "img_off", "img_wh")


def perturb(variables, seed=0):
    """Seeded noise on what JAX initialises to constants, so that every
    parameter matters: the zero offset and attention-weight kernels, the
    biases (the offsets' radial rings excepted), the norm scales and the
    BatchNorm statistics."""
    r = np.random.default_rng(seed)

    def f(path, x):
        key = jax.tree_util.keystr(path)
        x = np.array(x)
        if ("sampling_offsets" in key or "attention_weights" in key) and "kernel" in key:
            return x + r.normal(0, 0.05, x.shape).astype(np.float32)
        if key.endswith("['scale']"):
            return r.uniform(0.8, 1.2, x.shape).astype(np.float32)
        if key.endswith("['bias']") and "sampling_offsets" not in key:
            return x + r.normal(0, 0.05, x.shape).astype(np.float32)
        if key.endswith("['mean']"):
            return r.normal(0, 0.1, x.shape).astype(np.float32)
        if key.endswith("['var']"):
            return r.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, variables)


def init_variables(port_model, seed=0):
    """JAX variables of ``port_model``'s configuration: its seeded init read
    by the JAX converter (``convert_reference_state_dict``, which the round
    trips hold to the JAX tree), perturbed. Cheaper than tracing the JAX
    model's init."""
    sd = {k: v.detach().numpy() for k, v in port_model.state_dict().items()}
    return perturb(jax.tree.map(np.asarray, convert_reference_state_dict(sd)), seed)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def close(ours, ref, rel):
    """``ours`` (a tensor) within ``rel`` of ``max(1, max|ref|)`` of ``ref``."""
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def to_target_grid(outputs, batch):
    """The JAX model's per-view head maps resized (``jax.image.resize``,
    bilinear) to the per-view targets' grid where a stride-16 trunk left
    them coarser: the port's loss does so (``train/trainer.py::supervised_loss``)."""
    world, imgs = outputs
    grid = tuple(batch["imgs_gt"]["heatmap"].shape[2:4])
    if tuple(imgs[0].shape[1:3]) != grid:
        imgs = tuple(jax.image.resize(x, (x.shape[0],) + grid + (x.shape[3],), "bilinear") for x in imgs)
    return world, imgs


def jax_loss_and_grads(jax_model, variables, batch, mesh=None):
    """The JAX loss terms and gradients of one training-mode forward (no
    dropout rng is consumed at rate 0), with the parameters in f64 under
    ``jax.enable_x64`` (the uint8 frames are still normalised in f32). With
    a JAX ``mesh`` the batch is sharded over it as the JAX package's sharded
    step shards it (``mvdetr_tpu.parallel.shard_batch``: the frames over
    ``data``) and the parameters replicated, so XLA takes BatchNorm's
    statistics and the loss over the global batch through its collectives.

    Why f64: JAX's own f32 gradients on the CPU lose precision in the
    trunk's dilated stages. On ``test_torch_port_variants.py``'s conv
    fixture, layers 1-3 of JAX's f32 run are 0.5-1.3e-2 (relative L2) off
    its f64 run, while the port's f32 run is within 7e-6 of it and JAX's
    and the port's f64 runs agree to 1.3e-6; a 1e-2 gate against JAX's f32
    run would measure JAX's error, not the port's."""
    with jax.enable_x64():
        jbatch = jax.tree.map(jnp.asarray, batch)
        var64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        if mesh is not None:
            from mvdetr_tpu.parallel.sharding import replicated, shard_batch

            jbatch, var64 = shard_batch(batch, mesh), jax.device_put(var64, replicated(mesh))

        def loss_fn(params):
            outputs, _ = jax_model.apply({"params": params, "batch_stats": var64["batch_stats"]}, jbatch["imgs"],
                                         jbatch["affine_mats"], train=True, mutable=["batch_stats", "diagnostics"],
                                         rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_supervised_loss(to_target_grid(outputs, batch), jbatch)

        (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(var64["params"])
        return {k: float(aux[k]) for k in LOSS_KEYS}, flat(grads)


def port_step(port, variables, batch, lr=5e-4, total_steps=100):
    """One ``train_step`` of ``port`` from ``variables`` on the CPU: the loss
    terms, and the gradients as the JAX tree's leaves (through the JAX
    converter, so they are compared leaf for leaf)."""
    port.load_state_dict(from_jax_variables(variables, device="cpu"))
    sd = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()}
    state = create_train_state(port, lr=lr, total_steps=total_steps)
    _, aux = train_step(state, batch, torch.Generator().manual_seed(0), device="cpu")
    sd.update({n: p.grad.detach().numpy().copy() for n, p in port.named_parameters()})
    return {k: float(aux[k]) for k in LOSS_KEYS}, flat(convert_reference_state_dict(sd)["params"])


def assert_grads_match(ours: dict, ref: dict) -> None:
    """Every gradient leaf within 1e-2 in relative L2 (trunk gradients are
    ill-conditioned at test size, see ``test_torch_port_train.py``). The
    attention's key bias adds ``q . b`` to every logit of a query, which the
    softmax cancels: its gradient is 0 up to rounding, so both sides must be
    below 1e-4 of the key kernel's instead."""
    assert ours.keys() == ref.keys()
    bad = {}
    for k, g in ref.items():
        if k.endswith("['key']['bias']"):
            scale = np.linalg.norm(ref[k.replace("['bias']", "['kernel']")])
            if not max(np.linalg.norm(ours[k]), np.linalg.norm(g)) <= 1e-4 * scale:
                bad[k] = (np.linalg.norm(ours[k]), np.linalg.norm(g), scale)
        elif not np.linalg.norm(ours[k] - g) <= 1e-2 * np.linalg.norm(g):
            bad[k] = np.linalg.norm(ours[k] - g) / np.linalg.norm(g)
    assert not bad, f"gradient leaves off: {bad}"


def assert_step_matches(ours, ref):
    """Loss terms to 1e-5 relative, gradients as :func:`assert_grads_match`."""
    (port_aux, port_grads), (jax_aux, jax_grads) = ours, ref
    for k in LOSS_KEYS:
        np.testing.assert_allclose(port_aux[k], jax_aux[k], rtol=1e-5, err_msg=k)
    assert_grads_match(port_grads, jax_grads)


def assert_round_trip(state_dict, variables):
    """``convert_reference_state_dict(port.state_dict())`` is the JAX
    variables, leaf for leaf and bit for bit."""
    back = convert_reference_state_dict({k: v.detach().numpy() for k, v in state_dict.items()})
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert flat_back.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_back[k]), np.asarray(v), err_msg=jax.tree_util.keystr(k))


def forward_pair(jax_model, port_model, variables, imgs, aff):
    """Both models at inference on the same uint8 frames: ``(ours, ref)``
    leaves in the heads' order."""
    ref = jax.jit(lambda v, i, a: jax_model.apply(v, i, a, train=False, mutable=["diagnostics"])[0])(
        variables, jnp.asarray(imgs), jnp.asarray(aff))
    port_model.load_state_dict(from_jax_variables(variables, device="cpu"))
    with torch.no_grad():
        ours, _ = port_model(torch.from_numpy(imgs), torch.from_numpy(aff))
    return [*ours[0], *ours[1]], jax.tree.leaves(ref)


def checkpoint_forward_pair(path, jax_model, port_model, imgs, aff):
    """A ``MultiviewDetector.pth`` at ``path`` through both loaders
    (``mvdetr_tpu.interop.load_torch_checkpoint`` and the port's), then both
    models at inference on the same frames: ``(ours, ref, detected config)``."""
    from mvdetr_tpu.interop import load_torch_checkpoint as jax_load_torch_checkpoint
    from mvdetr_tpu_torch.interop import load_torch_checkpoint

    jvars = jax_load_torch_checkpoint(path)
    ref = jax.jit(lambda v, i, a: jax_model.apply(v, i, a, train=False, mutable=["diagnostics"])[0])(
        jvars, jnp.asarray(imgs), jnp.asarray(aff))
    model, cfg = load_torch_checkpoint(path, port_model, with_config=True)
    with torch.no_grad():
        ours, _ = model(torch.from_numpy(imgs), torch.from_numpy(aff))
    return [*ours[0], *ours[1]], jax.tree.leaves(ref), cfg
