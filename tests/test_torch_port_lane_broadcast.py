"""Kernel B5, the lane broadcast / reduce experiment
(``mvdetr_tpu_torch/ops/lane_broadcast.py``), against the TPU script's kernel
bodies (``scripts/exp_vpu_broadcast.py:81-136``) run by ``pl.pallas_call`` in
interpret mode with the script's VMEM block specs.

The script builds its bodies inside ``main()`` at a fixed T and REPS and
cannot be imported without its TPU-only ``_bench``, so they are copied here,
parametrised by T and REPS. Sizes: the flagship widths L=7, M=8, D=16 (LM=56,
LK=896), T=24 rows, REPS 1 and 3.

Tolerance: 1e-5 of max|ref|. The broadcast sums are the same f32 operations
in the same order on both sides (E's products are exact); the reduce sums 16
lanes in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mvdetr_tpu.ops.pallas.msda_kernel import _select_matrices
from mvdetr_tpu_torch.ops import lane_broadcast as lb
from mvdetr_tpu_torch.ops.lane_broadcast import (
    BROADCAST_VARIANTS,
    D,
    LM,
    VARIANTS,
    lane_broadcast,
    lane_reduce,
    select_matrix_e,
)

T = 24
L_LEVELS, M_HEADS, P_POINTS = 7, 8, 4
LK = LM * D
RTOL = 1e-5


def _tpu_bodies(t: int, reps: int) -> dict:
    """The six kernel bodies of ``scripts/exp_vpu_broadcast.py:81-136``, with
    the script's constants T and REPS made parameters."""

    def k_matmul(x_ref, e_ref, v_ref, o_ref):
        acc = jnp.zeros((t, LK), jnp.float32)
        for i in range(reps):
            cwlk = jnp.dot(x_ref[...] + float(i), e_ref[...], preferred_element_type=jnp.float32)
            acc += cwlk * v_ref[...].astype(jnp.float32)
        o_ref[...] = acc

    def k_repeat(x_ref, v_ref, o_ref):
        acc = jnp.zeros((t, LK), jnp.float32)
        for i in range(reps):
            cwlk = pltpu.repeat(x_ref[...] + float(i), D, axis=1)
            acc += cwlk * v_ref[...].astype(jnp.float32)
        o_ref[...] = acc

    def k_jnp_repeat(x_ref, v_ref, o_ref):
        acc = jnp.zeros((t, LK), jnp.float32)
        for i in range(reps):
            cwlk = jnp.repeat(x_ref[...] + float(i), D, axis=1)
            acc += cwlk * v_ref[...].astype(jnp.float32)
        o_ref[...] = acc

    def k_bcast3d(x_ref, v_ref, o_ref):
        acc = jnp.zeros((t, LM, D), jnp.float32)
        v3 = v_ref[...].reshape(t, LM, D)
        for i in range(reps):
            cwlk = jax.lax.broadcast_in_dim(x_ref[...] + float(i), (t, LM, D), (0, 1))
            acc += cwlk * v3.astype(jnp.float32)
        o_ref[...] = acc.reshape(t, LK)

    def r_matmul(x_ref, et_ref, o_ref):
        acc = jnp.zeros((t, LM), jnp.float32)
        for i in range(reps):
            acc += jnp.dot(x_ref[...] + float(i), et_ref[...], preferred_element_type=jnp.float32)
        o_ref[...] = acc

    def r_reshape_sum(x_ref, o_ref):
        acc = jnp.zeros((t, LM), jnp.float32)
        for i in range(reps):
            acc += jnp.sum((x_ref[...] + float(i)).reshape(t, LM, D), axis=2)
        o_ref[...] = acc

    return {"matmul": k_matmul, "repeat": k_repeat, "jnp_repeat": k_jnp_repeat, "bcast3d": k_bcast3d,
            "r_matmul": r_matmul, "r_reshape_sum": r_reshape_sum}


def _interpret(body, inputs, out_cols):
    """``pl.pallas_call`` as the script's ``_bench`` makes it, in interpret mode."""
    call = pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct((inputs[0].shape[0], out_cols), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM) for _ in inputs],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(call(*inputs))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, LM)).astype(np.float32)
    dlk = rng.standard_normal((T, LK)).astype(np.float32)
    v = np.asarray(jnp.asarray(rng.standard_normal((T, LK)), jnp.bfloat16))  # bf16 values, as the script makes them
    return x, dlk, v


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_variant_matches_tpu_body_in_interpret_mode(variant, reps):
    x, dlk, v = _inputs()
    body = _tpu_bodies(T, reps)[variant]
    e = select_matrix_e(M_HEADS, L_LEVELS, D)
    if variant in BROADCAST_VARIANTS:
        args = (x, e, v) if variant == "matmul" else (x, v)
        ref = _interpret(body, [jnp.asarray(a) for a in args], LK)
        ours = lane_broadcast(torch.from_numpy(x), torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16),
                              variant, reps)
    else:
        args = (dlk, e.T.copy()) if variant == "r_matmul" else (dlk,)
        ref = _interpret(body, [jnp.asarray(a) for a in args], LM)
        ours = lane_reduce(torch.from_numpy(dlk), variant, reps)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=RTOL * float(np.abs(ref).max()))


def test_select_matrix_e_is_the_jax_packages_e():
    np.testing.assert_array_equal(select_matrix_e(M_HEADS, L_LEVELS, D),
                                  _select_matrices(M_HEADS, L_LEVELS, P_POINTS, D)[1])
    np.testing.assert_array_equal(select_matrix_e(3, 2, 5), _select_matrices(3, 2, 1, 5)[1])


def test_repeat_variant_tiles_the_row():
    """``pltpu.repeat(x, D, axis=1)`` is ``np.tile``, not ``np.repeat``: at one
    repetition the ``repeat`` variant is ``tile(x) * v`` and differs from the
    broadcast ``repeat_interleave(x) * v``."""
    x, _, v = _inputs(1)
    vt = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    ours = lane_broadcast(torch.from_numpy(x), vt, "repeat", 1).numpy()
    vf = v.astype(np.float32)
    np.testing.assert_array_equal(ours, np.tile(x, (1, D)) * vf)
    body = _interpret(_tpu_bodies(T, 1)["repeat"], [jnp.asarray(x), jnp.asarray(v)], LK)
    np.testing.assert_array_equal(body, np.tile(x, (1, D)) * vf)
    bcast = lane_broadcast(torch.from_numpy(x), vt, "jnp_repeat", 1).numpy()
    np.testing.assert_array_equal(bcast, np.repeat(x, D, axis=1) * vf)
    assert np.abs(ours - bcast).max() > 1.0


def test_wrappers_dispatch_by_device(monkeypatch):
    """A CPU tensor runs the plain version and launches nothing; an unknown
    variant raises; the experiment's entry point raises without a card."""
    from mvdetr_tpu_torch.scripts import exp_vpu_broadcast

    x, dlk, v = _inputs(2)
    vt = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    before = (dict(lane_broadcast.launches), dict(lane_reduce.launches))
    out = lane_broadcast(torch.from_numpy(x), vt, "bcast3d", 2)
    torch.testing.assert_close(out, lb.lane_broadcast_plain(torch.from_numpy(x), vt, "bcast3d", 2), rtol=0, atol=0)
    red = lane_reduce(torch.from_numpy(dlk), "r_reshape_sum", 2)
    assert red.shape == (T, LM) and out.shape == (T, LK)
    assert (dict(lane_broadcast.launches), dict(lane_reduce.launches)) == before
    with pytest.raises(ValueError, match="unknown broadcast variant"):
        lane_broadcast(torch.from_numpy(x), vt, "r_matmul")
    with pytest.raises(ValueError, match="unknown reduce variant"):
        lane_reduce(torch.from_numpy(dlk), "matmul")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_vpu_broadcast.main()
