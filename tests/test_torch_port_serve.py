"""The serving step: the port's ``eval_step`` against the JAX ``eval_step`` on a
batch of the JAX ``FrameDataset(SyntheticScene)`` with augmentation on.

The heads and the sorted top-K scores are continuous in the inputs and are
compared within the f32 tolerance of ``test_torch_port_model.py``. Top-K
order and NMS keep masks are not (a near-tie may flip), so they are held
exactly equal on identical inputs: the port's decode tail is fed the JAX
heads and compared with the JAX decode tail on the same arrays."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mvdetr_tpu.data import FrameDataset, SyntheticScene
from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.ops import distance_nms as jax_distance_nms
from mvdetr_tpu.ops import mvdet_decode as jax_mvdet_decode
from mvdetr_tpu.train import eval_step as jax_eval_step
from mvdetr_tpu.train.state import TrainState
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.train import decode_detections, eval_step

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
WORLD_REDUCE, K = 2, 64


@pytest.fixture(scope="module")
def served():
    jax_rig = jax_make_rig(**RIG)
    scene = SyntheticScene(jax_rig, num_frame=4, num_person=5, seed=3)
    ds = FrameDataset(scene, train=True, world_reduce=WORLD_REDUCE, img_reduce=12, top_k=8,
                      world_kernel_size=4, img_kernel_size=4, augmentation=True)
    batch = next(ds.batches(batch_size=2))
    assert batch["imgs"].dtype == np.uint8
    assert not np.allclose(batch["affine_mats"], np.eye(3))

    jm = JaxMVDeTr.from_rig(jax_rig, world_reduce=WORLD_REDUCE, img_reduce=12)
    init = jax.jit(lambda k: jm.init({"params": k}, jnp.asarray(batch["imgs"][:1]),
                                     jnp.asarray(batch["affine_mats"][:1]), train=False))
    var = init(jax.random.PRNGKey(5))
    r = np.random.default_rng(0)
    # give the zero-initialised offset/attention kernels values, so offsets vary per query
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + r.normal(0, 0.05, x.shape).astype(np.float32)
        if "kernel" in jax.tree_util.keystr(p) and ("offsets" in jax.tree_util.keystr(p)
                                                     or "attention_weights" in jax.tree_util.keystr(p))
        else np.asarray(x), var["params"])
    variables = {"params": params, "batch_stats": jax.tree.map(np.asarray, var["batch_stats"])}
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=optax.identity(),
                              batch_stats=variables["batch_stats"])
    jax_out = jax_eval_step(state, jax.tree.map(jnp.asarray, batch), world_reduce=WORLD_REDUCE, num_candidates=K)
    (jax_heads, _), _ = jax.jit(lambda v, i, a: jm.apply(v, i, a, train=False, mutable=["diagnostics"]))(
        variables, jnp.asarray(batch["imgs"]), jnp.asarray(batch["affine_mats"]))

    port = MVDeTr.from_rig(make_synthetic_rig(**RIG), world_reduce=WORLD_REDUCE, img_reduce=12, device="cpu")
    port.load_state_dict(from_jax_variables(variables, device="cpu"))
    return dict(batch=batch, jax_out=jax_out, jax_heads=jax_heads, port=port)


def test_eval_step_matches_jax(served):
    aux, xys, keep = eval_step(served["port"], served["batch"], world_reduce=WORLD_REDUCE,
                               num_candidates=K, device="cpu")
    jaux, jxys, jkeep = served["jax_out"]
    assert xys.shape == jxys.shape == (2, K, 3) and keep.shape == jkeep.shape == (2, K)
    assert keep.dtype == torch.bool
    np.testing.assert_allclose(xys[..., 2].numpy(), np.asarray(jxys[..., 2]), atol=1e-5)
    np.testing.assert_allclose(float(aux["offset_clip_fraction"]), float(jaux["offset_clip_fraction"]),
                               atol=1e-6)
    assert 0.0 < float(aux["offset_clip_fraction"]) < 1.0


def test_heads_match_and_decode_is_exact_on_identical_heads(served):
    """Forward heads within f32 tolerance; then the port's decode tail and the
    JAX one (`trainer.py:124-131`) on the same JAX heads give equal arrays."""
    jh, jo = (np.array(x) for x in served["jax_heads"])
    with torch.no_grad():
        ((ph, po), _), _ = served["port"](torch.from_numpy(served["batch"]["imgs"]),
                                          torch.from_numpy(served["batch"]["affine_mats"]))
    for ours, ref in ((ph, jh), (po, jo)):
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4 * max(1.0, np.abs(ref).max()))

    xys, keep = decode_detections(torch.from_numpy(jh), torch.from_numpy(jo), WORLD_REDUCE, K, 20.0)
    dense = jax_mvdet_decode(jax.nn.sigmoid(jnp.asarray(jh)), jnp.asarray(jo), reduce=WORLD_REDUCE)
    top_scores, top_idx = jax.lax.top_k(dense[:, :, 2], K)
    top_xy = jnp.take_along_axis(dense[:, :, :2], top_idx[..., None], axis=1)
    ref_keep = jax.vmap(lambda p, s: jax_distance_nms(p, s, 20.0))(top_xy, top_scores)
    ref_xys = jnp.concatenate([top_xy, top_scores[..., None]], axis=-1)
    np.testing.assert_array_equal(xys.numpy(), np.asarray(ref_xys))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    assert keep.any()
