"""The port's process layer (``mvdetr_tpu_torch/parallel``) on the CPU:

- the mesh, the batch slice, the host check and the collectives in one
  process, where a missing process group makes every collective the
  identity;
- two gloo processes (``tests/_torch_port_dist_worker.py``, the
  ``tests/_multihost_worker.py`` pattern with a port and a timeout of its
  own), once with ``data=2`` and once with ``bev=2``, both pairs at once,
  every step from the same seeded, perturbed weights: the sharded windowed
  attention against the unsharded one (``bev``: the real halo exchange);
  one sharded train step against the one-process step on the same global
  batch, with the same dropout generator; with ``data``, one step without
  dropout against JAX's step on a ``data=2`` mesh of the 8 CPU devices;
  then the CLI's epoch and test with ``--num_processes 2`` and
  ``--deterministic true``.

Tolerances. The two ranks of a run agree bitwise. Against the one-process
step, the loss and the parameters after the step within JAX's own
tolerances for its sharded steps (``tests/test_parallel.py``): ``bev`` (its
8-shard test) rtol 2e-5 and atol 1e-5, ``data`` (its 2 data x 4 view test)
rtol 2e-4 and atol 3e-4. Those cannot tell a wrong gradient (the first
step's learning rate is 4e-5), so the gradients the optimizer applied are
held leaf by leaf in relative L2: ``bev`` within 1e-5; ``data`` within 1e-5
of the one-process step whose BatchNorm statistics are split as the ranks
split them, and within 2e-2 of the plain one (the split rounds the
statistics differently, which the trunk's ReLU and max-pool gates amplify;
a BatchNorm all-reduce whose backward does not reach the other rank is
~0.6 off). Against JAX: the tolerances of the port's one-process steps
(loss terms rtol 1e-5, each gradient leaf 1e-2 in relative L2 of JAX's f64
gradients). The attention: the forward and the offsets' and weights'
gradients bitwise equal to the unsharded attention, the value's gradient
within a few f32 ulps, atol 1e-6 plus rtol 1e-6 (two shards' halo gradients
add up in another order).
"""


import functools
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from mvdetr_tpu.geometry import make_synthetic_rig as jax_make_rig
from mvdetr_tpu.interop import convert_reference_state_dict
from mvdetr_tpu.models import MVDeTr as JaxMVDeTr
from mvdetr_tpu.models.world_feat import modules as jax_modules
from mvdetr_tpu.parallel import make_mesh as jax_make_mesh
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models.layers import BatchNorm2d
from mvdetr_tpu_torch.ops.msda_windowed import windowed_attention
from mvdetr_tpu_torch.parallel import Mesh, initialize_distributed, make_mesh, process_batch_slice
from mvdetr_tpu_torch.parallel.mesh import rank_grid
from mvdetr_tpu_torch.parallel.collectives import all_reduce_sum, gather_rows, reduce_sum, take_rows
from mvdetr_tpu_torch.parallel.multihost import check_processes_per_host
from mvdetr_tpu_torch.parallel.sharding import shard_batch
from mvdetr_tpu_torch.train import train_step

from _torch_port import few_torch_threads  # noqa: F401
from _torch_port_dist_worker import ATTENTION_RADIUS, STEP_SEED, attention_inputs, tiny_setup
from _torch_port_jax import LOSS_KEYS, assert_step_matches, flat, init_variables, jax_loss_and_grads

pytestmark = pytest.mark.usefixtures("few_torch_threads")

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_port_dist_worker.py")
TIMEOUT_S = 240
# (loss rtol, parameters atol, each gradient leaf's relative L2) against the one-process step
TOLERANCES = {"bev": (2e-5, 1e-5, 1e-5), "data": (2e-4, 3e-4, 2e-2)}
SPLIT_GRAD_RTOL = 1e-5  # data: against the one-process step with BatchNorm's statistics split as the ranks split them


def test_one_process_mesh_has_no_groups():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "view": 1, "bev": 1} and mesh.rank == 0 and mesh.world_group is None
    assert [mesh.index(a) for a in ("data", "view", "bev")] == [0, 0, 0] and mesh.group("data") is None
    with pytest.raises(ValueError, match="not divisible into 1 view x 2 bev"):
        make_mesh(num_bev_shards=2)
    with pytest.raises(ValueError, match="needs as many torch.distributed processes"):
        make_mesh(world_size=2)
    with pytest.raises(ValueError, match="not divisible into 2 view x 1 bev"):
        make_mesh(num_view_shards=2)
    # the view mesh's layout: 8 processes as data 2 x view 2 x bev 2, rank-major; a data x view slice per bev index
    grid = rank_grid(8, num_view_shards=2, num_bev_shards=2)
    assert grid.shape == (2, 2, 2) and [int(i) for i in np.argwhere(grid == 5)[0]] == [1, 0, 1]
    assert sorted(grid[:, :, 1].reshape(-1).tolist()) == [1, 3, 5, 7] and grid[1, :, 0].tolist() == [4, 6]
    assert rank_grid(4, num_view_shards=2).shape == (2, 2, 1)


def test_batch_slice_and_shard_batch():
    mesh = Mesh({"data": 2, "view": 1, "bev": 1}, rank=1, coords={"data": 1, "view": 0, "bev": 0}, groups={})
    assert process_batch_slice(4, mesh) == slice(2, 4) and process_batch_slice(4, None) == slice(0, 4)
    with pytest.raises(ValueError, match="does not divide over data=2"):
        process_batch_slice(3, mesh)
    bev = Mesh({"data": 1, "view": 1, "bev": 2}, rank=1, coords={"data": 0, "view": 0, "bev": 1}, groups={})
    assert process_batch_slice(4, bev) == slice(0, 4)  # a bev shard computes the whole batch
    batch = {"imgs": np.arange(4), "frame": np.arange(4) + 10, "world_gt": {"idx": np.arange(8).reshape(4, 2)}}
    cut = shard_batch(batch, mesh)
    assert cut["imgs"].tolist() == [2, 3] and cut["frame"].tolist() == [12, 13]
    assert cut["world_gt"]["idx"].tolist() == [[4, 5], [6, 7]]


def test_host_check_and_single_process_start():
    check_processes_per_host([("a", 1), ("b", 1)])
    check_processes_per_host([("a", 2), ("a", 2), ("b", 1)])
    with pytest.raises(RuntimeError, match=r"2 processes \(ranks \[0, 1\]\) on host 'a', which has 1 GPU"):
        check_processes_per_host([("a", 1), ("a", 1)])
    assert initialize_distributed(None, None, None, "cpu") is None and initialize_distributed("h:1", 1, 0, "cpu") is None
    with pytest.raises(ValueError, match="needs --process_id and --coordinator_address"):
        initialize_distributed(None, 2, None, "cpu")
    with pytest.raises(ValueError, match="host:port"):
        initialize_distributed("localhost", 2, 0, "cpu")


def test_collectives_without_a_group_are_the_identity():
    x = torch.randn(2, 3, 4, requires_grad=True)
    for fn in (lambda t: reduce_sum(t, None), lambda t: all_reduce_sum(t, None), lambda t: take_rows(t, None),
               lambda t: gather_rows(t, None)):
        assert fn(x) is x


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded, perturbed JAX variables of the tiny model (so that every
    parameter matters) and the port's state dict of them, saved for the
    workers: every step of this file starts from them."""
    _, state = tiny_setup(dropout=0.0)
    variables = init_variables(state.model, seed=3)
    path = tmp_path_factory.mktemp("weights") / "init.pt"
    torch.save(from_jax_variables(variables, device="cpu"), path)
    return variables, path


def _jax_sharded_step(variables):
    """JAX's loss terms and gradients of the global batch's step on a mesh
    of ``data=2`` of the 8 CPU devices, without dropout (the model's
    dropout patched to 0, as the port's ``nodrop`` step runs), in f64."""
    batch, _ = tiny_setup(dropout=0.0)
    jax_model = JaxMVDeTr.from_rig(jax_make_rig(num_cam=2, img_shape=(48, 96), worldgrid_shape=(32, 64)),
                                   world_reduce=2, img_reduce=12)
    mesh = jax_make_mesh(devices=jax.devices()[:2])
    assert dict(mesh.shape) == {"data": 2, "view": 1, "bev": 1}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_modules, "DeformTransWorldFeat", functools.partial(jax_modules.DeformTransWorldFeat,
                                                                          dropout=0.0))
        return jax_loss_and_grads(jax_model, variables, batch, mesh=mesh)


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory, weights):
    """Both 2-process runs at once: ``{axis: (outdir, [stdout of rank 0, 1])}``,
    and under ``"jax"`` JAX's sharded step (:func:`_jax_sharded_step`),
    computed while the workers run."""
    variables, path = weights
    procs = {}
    for axis in ("data", "bev"):
        out = tmp_path_factory.mktemp(axis)
        port = _free_port()
        procs[axis] = (out, [subprocess.Popen([sys.executable, WORKER, str(port), "2", str(i), axis, str(out),
                                               str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                              text=True)
                             for i in range(2)])
    runs = {}
    try:
        runs["jax"] = _jax_sharded_step(variables)
        for axis, (out, ps) in procs.items():
            texts = []
            for p in ps:
                text, _ = p.communicate(timeout=TIMEOUT_S)
                assert p.returncode == 0, f"{axis} worker failed (rc={p.returncode}):\n{text[-4000:]}"
                texts.append(text)
            runs[axis] = (out, texts)
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return runs


def _split_statistics_forward(self, x):
    """``BatchNorm2d.forward`` with the training statistics of ``data=2``
    in one process: the mean of the two halves' f32 means of x and x^2, as
    the two ranks all-reduce them (``models/layers.py``)."""
    x32 = x.float()
    if not self.training:
        return self.__class__._plain_forward(self, x)
    half = x32.shape[0] // 2
    means = [torch.stack([p.mean(dim=(0, 2, 3)), (p * p).mean(dim=(0, 2, 3))]) for p in (x32[:half], x32[half:])]
    mean, square = (means[0] + means[1]) / 2
    var = torch.clamp(square - mean * mean, min=0.0)
    self._update_running_stats(mean, var)
    mul = torch.rsqrt(var + self.eps) * self.weight
    return ((x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(self.dtype)


def _one_process_step(weights, split_statistics=False):
    batch, state = tiny_setup(weights=torch.load(weights[1]))
    with pytest.MonkeyPatch.context() as mp:
        if split_statistics:
            mp.setattr(BatchNorm2d, "_plain_forward", BatchNorm2d.forward, raising=False)
            mp.setattr(BatchNorm2d, "forward", _split_statistics_forward)
        _, aux = train_step(state, batch, torch.Generator().manual_seed(STEP_SEED), device="cpu")
    named = list(state.model.named_parameters())
    return (float(aux["loss"]), {n: p.grad.numpy() for n, p in named}, {n: p.detach().numpy() for n, p in named})


@pytest.fixture(scope="module")
def one_process_step(weights):
    """The one-process train step on the workers' global batch, from the
    same weights with the same dropout generator: its loss, gradients and
    parameters after the step."""
    return _one_process_step(weights)


def _lines(text, prefix):
    return [line for line in text.splitlines() if line.startswith(prefix)]


def _assert_grads_within(record, grads, rtol):
    """Every gradient leaf of a worker's ``record`` within ``rtol`` of
    ``grads`` in relative L2."""
    off = {n: np.linalg.norm(record[f"grad:{n}"] - ref) / np.linalg.norm(ref) for n, ref in grads.items()}
    assert max(off.values()) <= rtol, sorted(off.items(), key=lambda kv: -kv[1])[:5]


def test_two_process_data_step_against_the_split_statistics_step(two_process_runs, weights):
    """The data=2 step's gradients against the one-process step whose
    BatchNorm statistics are split as the ranks split them: the same
    arithmetic but for the order of the gradient sums, so within
    SPLIT_GRAD_RTOL. Against the plain one-process step the trunk's leaves
    are up to ~1e-2 off: the split means round differently and the trunk's
    ReLU and max-pool gates turn that into whole elements."""
    out, _ = two_process_runs["data"]
    _assert_grads_within(np.load(out / "step0.npz"), _one_process_step(weights, split_statistics=True)[1],
                         SPLIT_GRAD_RTOL)


@pytest.mark.parametrize("axis", ["data", "bev"])
def test_two_processes_agree_with_each_other_and_the_one_process_step(axis, two_process_runs, one_process_step):
    out, texts = two_process_runs[axis]
    shape = {"data": "{'data': 2, 'view': 1, 'bev': 1}", "bev": "{'data': 1, 'view': 1, 'bev': 2}"}[axis]
    coords = {"data": ["[0, 0, 0]", "[1, 0, 0]"], "bev": ["[0, 0, 0]", "[0, 0, 1]"]}[axis]
    for rank, text in enumerate(texts):  # a process group for the axis of two ranks only
        assert f"rank {rank}: mesh {shape} at {coords[rank]}, groups ['{axis}']" in text

    steps = [np.load(out / f"step{rank}.npz") for rank in range(2)]
    assert steps[0]["checksum"] == steps[1]["checksum"]
    assert steps[0].files == steps[1].files and all(np.array_equal(steps[0][k], steps[1][k]) for k in steps[0].files)
    loss, grads, params = one_process_step
    loss_rtol, params_atol, grad_rtol = TOLERANCES[axis]
    np.testing.assert_allclose(float(steps[0]["aux:loss"]), loss, rtol=loss_rtol)
    assert sorted(k for k in steps[0].files if k.startswith("grad:")) == sorted(f"grad:{n}" for n in grads)
    # the gradients the optimizer applied, summed over the ranks (the parameters after one step cannot tell a
    # wrong gradient: OneCycle's first learning rate moves them by <= 4e-5)
    _assert_grads_within(steps[0], grads, grad_rtol)
    for name, ref in params.items():
        np.testing.assert_allclose(steps[0][f"param:{name}"], ref, rtol=0, atol=params_atol, err_msg=name)

    # the CLI's epoch and test: the determinism check passed, the same loss and MODA on both ranks
    for text in texts:
        assert "determinism check passed" in text and f"mesh: {shape}" in text
    for prefix in ("Train epoch 1 done: loss", "Test: loss"):
        per_rank = [[re.sub(r", t [0-9.]+s$", "", line) for line in _lines(text, prefix)] for text in texts]
        assert per_rank[0] and per_rank[0] == per_rank[1], prefix
    assert len(_lines(texts[0], "Test: loss")) == 2 and "moda" in _lines(texts[0], "Test: loss")[0]
    assert (out / "run" / "test.txt").is_file() and (out / "run" / "checkpoints" / "2" / "state.pt").is_file()
    assert "mh2_seed" not in str(out / "run")  # --logdir names the directory; the tag is for runs without it


def test_two_process_data_step_against_the_jax_sharded_step(two_process_runs, weights):
    """The data=2 step without dropout against JAX's on a data=2 mesh from
    the same weights: the loss terms within 1e-5 and every gradient leaf
    within 1e-2 in relative L2, the tolerances of the port's one-process
    steps against JAX (``_torch_port_jax.assert_step_matches``)."""
    out, _ = two_process_runs["data"]
    variables, path = weights
    ranks = [np.load(out / f"nodrop{rank}.npz") for rank in range(2)]
    assert all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0].files)
    aux = {k: float(ranks[0][f"aux:{k}"]) for k in LOSS_KEYS}
    state = {k: v.numpy() for k, v in torch.load(path).items()}
    state.update({k[len("grad:"):]: ranks[0][k] for k in ranks[0].files if k.startswith("grad:")})
    assert_step_matches((aux, flat(convert_reference_state_dict(state)["params"])), two_process_runs["jax"])


def test_two_process_bev_attention_against_the_unsharded_attention(two_process_runs):
    out, _ = two_process_runs["bev"]
    *inputs, g = (torch.from_numpy(a) for a in attention_inputs())
    inputs = [t.requires_grad_() for t in inputs]
    ref = windowed_attention(*inputs, radius=ATTENTION_RADIUS, flatten=False)
    ref.backward(g)
    for rank in range(2):
        got = np.load(out / f"attention{rank}.npz")
        assert np.array_equal(got["out"], ref.detach().numpy())
        assert np.array_equal(got["g_offsets"], inputs[1].grad.numpy())
        assert np.array_equal(got["g_weights"], inputs[2].grad.numpy())
        np.testing.assert_allclose(got["g_value"], inputs[0].grad.numpy(), rtol=1e-6, atol=1e-6)
