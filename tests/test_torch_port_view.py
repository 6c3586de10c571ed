"""Camera sharding, the mesh's ``view`` axis, on the CPU:

- one process: :func:`~mvdetr_tpu_torch.parallel.sharding.shard_batch` cuts
  the camera axis of ``imgs``, ``affine_mats`` and ``imgs_gt`` after the
  frames (``world_gt`` over the frames only), and leaves the cameras whole
  where the axis does not divide them; the dropout masks of view ranks tile
  the one-process mask; ``DeformTransWorldFeat.compose_view_shards`` (the V
  ranks' query blocks in one process, the value gathered by concatenation)
  against the unsharded module;
- several gloo processes (``tests/_torch_port_dist_worker.py``), all runs at
  once from seeded, perturbed weights: ``view=2`` on a 4-camera rig (the
  sharded train step with dropout, one without, the CLI's epoch and test
  with ``--view_shards 2``), ``view=2`` on a 3-camera rig (the idle axis),
  ``view=2`` in gather mode (the encoder replicated over ``view`` on the
  gathered warped stack) and ``view=2 x bev=2`` in 4 processes; ``data=2 x view=2 x bev=2`` in 8
  processes is marked slow.

Tolerances. The ranks of a run agree bitwise. The composed module's forward
and clip fractions are bitwise the unsharded module's, its gradients within
1e-5 in relative L2 (measured ~5e-7: the value's gradient adds the ranks'
parts in another order). Against the one-process step, the loss within 2e-4
relative and the applied gradients leaf by leaf in relative L2 (as
``tests/test_torch_port_parallel.py`` holds the data and bev steps): within
1e-5 of the one-process step whose BatchNorm statistics are split as the
view ranks split the cameras, and within 2e-2 of the plain one (the split
means round differently, which the trunk's ReLU and max-pool gates
amplify, as on ``data``). The idle axis runs the one-process step on every
rank: its gradients are its bits (the reference runs on one thread, as the
workers do), not doubled. Against JAX's ``view=2`` step on two of the conftest's 8 CPU devices (f64, dropout 0):
the loss terms within 1e-5 relative and each gradient leaf within 1e-2
relative L2, the tolerances of the port's one-process steps against JAX.
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
from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.interop import from_jax_variables
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.models.layers import BatchNorm2d, Dropout
from mvdetr_tpu_torch.parallel import Mesh
from mvdetr_tpu_torch.parallel.collectives import gather_cams
from mvdetr_tpu_torch.parallel.mesh import view_shards
from mvdetr_tpu_torch.parallel.sharding import shard_batch
from mvdetr_tpu_torch.train import train_step

from _torch_port import few_torch_threads  # noqa: F401
from _torch_port_dist_worker import RUNS, STEP_SEED, tiny_setup
from _torch_port_jax import LOSS_KEYS, assert_step_matches, flat, init_variables, jax_loss_and_grads

pytestmark = pytest.mark.usefixtures("few_torch_threads")

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_port_dist_worker.py")
TIMEOUT_S = 240
PROCESSES = {"view": 2, "view_idle": 2, "view_gather": 2, "view_bev": 4}
LOSS_RTOL, SPLIT_GRAD_RTOL, PLAIN_GRAD_RTOL = 2e-4, 1e-5, 2e-2
COMPOSED_GRAD_RTOL = 1e-5


def _mesh(data, view, bev, rank):
    grid = np.arange(data * view * bev).reshape(data, view, bev)
    coords = dict(zip(("data", "view", "bev"), (int(i) for i in np.argwhere(grid == rank)[0])))
    return Mesh({"data": data, "view": view, "bev": bev}, rank=rank, coords=coords, groups={})


def test_shard_batch_cuts_the_cameras_after_the_frames():
    rng = np.random.default_rng(0)
    batch = {"imgs": rng.integers(0, 255, (4, 4, 3, 5, 3), np.uint8), "affine_mats": rng.random((4, 4, 3, 3)),
             "frame": np.arange(4) + 10, "world_gt": {"heatmap": rng.random((4, 6, 8, 1)), "idx": rng.random((4, 7))},
             "imgs_gt": {"heatmap": rng.random((4, 4, 2, 3, 1)), "idx": rng.random((4, 4, 7))}}
    mesh = _mesh(2, 2, 1, rank=3)  # data 1, view 1
    cut = shard_batch(batch, mesh)
    for key in ("imgs", "affine_mats"):
        assert np.array_equal(cut[key], batch[key][2:4, 2:4])
    for key in ("heatmap", "idx"):
        assert np.array_equal(cut["imgs_gt"][key], batch["imgs_gt"][key][2:4, 2:4])
        assert np.array_equal(cut["world_gt"][key], batch["world_gt"][key][2:4])
    assert cut["frame"].tolist() == [12, 13]
    assert view_shards(mesh, 4) == 2 and view_shards(mesh, 3) == 1 and view_shards(None, 4) == 1
    # a view axis that does not divide the cameras is idle: every view rank keeps every camera
    idle = shard_batch({k: (v[:, :3] if k in ("imgs", "affine_mats") else v) for k, v in batch.items()
                        if k != "imgs_gt"}, _mesh(1, 2, 1, rank=1))
    assert idle["imgs"].shape[1] == 3 and np.array_equal(idle["imgs"], batch["imgs"][:, :3])
    x = torch.randn(2, 3, 4, requires_grad=True)
    assert gather_cams(x, None) is x


def test_dropout_masks_of_view_ranks_tile_the_one_process_mask():
    """A [B, N, C, H, W] Dropout2d and a [B, Q, C] token dropout: the ranks
    of data 2 x view 2, each drawing from the same generator and keeping its
    block, apply the one-process mask."""
    for shape, channels in (((4, 6, 5, 3, 2), True), ((4, 12, 5), False)):
        x = torch.randn(shape)
        one = Dropout(0.5, channels=channels).train()
        one.generator = torch.Generator().manual_seed(3)
        ref = one(x)
        rows, cols = shape[0] // 2, shape[1] // 2
        for di in range(2):
            for vi in range(2):
                rank = Dropout(0.5, channels=channels).train()
                rank.generator = torch.Generator().manual_seed(3)
                rank.shards = ((0, di, 2), (1, vi, 2))
                block = x[di * rows:(di + 1) * rows, vi * cols:(vi + 1) * cols]
                assert torch.equal(rank(block), ref[di * rows:(di + 1) * rows, vi * cols:(vi + 1) * cols])


@pytest.mark.parametrize("shards", [2, 4])
def test_composed_view_shards_of_the_shadow_transformer(shards):
    """The windowed shadow transformer of a 4-camera rig as ``shards`` view
    ranks in one process: the forward and the clip fractions bitwise the
    unsharded module's; the parameters' and the input's gradients within
    COMPOSED_GRAD_RTOL."""
    rig = make_synthetic_rig(num_cam=4, img_shape=(48, 96), worldgrid_shape=(32, 64))
    wf = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, device="cpu", seed=1, attn_mode="windowed",
                         encoder_dropout=0.0).world_feat
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in wf.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    x = torch.randn((2, 4, 16, 32, 128), generator=gen)
    g = None
    results = []
    for compose in (False, True):
        xi = x.clone().requires_grad_()
        y, clips = wf.compose_view_shards(xi, shards) if compose else wf(xi)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(5)) if g is None else g
        wf.zero_grad()
        y.backward(g)
        grads = {n: p.grad.clone() for n, p in wf.named_parameters()}
        grads["input"] = xi.grad
        results.append((y.detach(), torch.stack(clips), grads))
    (y0, c0, g0), (y1, c1, g1) = results
    assert torch.equal(y0, y1) and torch.equal(c0, c1)
    off = {n: float((g1[n] - g).norm() / g.norm()) for n, g in g0.items()}
    assert max(off.values()) <= COMPOSED_GRAD_RTOL, sorted(off.items(), key=lambda kv: -kv[1])[:5]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def view_weights(tmp_path_factory):
    """Per rig (3 and 4 cameras): seeded, perturbed JAX variables of the
    tiny model and the port's state dict of them, saved for the workers."""
    out = {}
    for cams in (3, 4):
        _, state = tiny_setup(dropout=0.0, num_cam=cams)
        variables = init_variables(state.model, seed=3)
        path = tmp_path_factory.mktemp(f"weights{cams}") / "init.pt"
        torch.save(from_jax_variables(variables, device="cpu"), path)
        out[cams] = (variables, path)
    return out


def _jax_view_step(variables):
    """JAX's loss terms and gradients of the 4-camera global batch's step on
    a ``view=2`` mesh of two CPU devices, without dropout, in f64."""
    batch, _ = tiny_setup(dropout=0.0, num_cam=4)
    jax_model = JaxMVDeTr.from_rig(jax_make_rig(num_cam=4, img_shape=(48, 96), worldgrid_shape=(32, 64)),
                                   world_reduce=2, img_reduce=12)
    mesh = jax_make_mesh(num_view_shards=2, devices=jax.devices()[:2])
    assert dict(mesh.shape) == {"data": 1, "view": 2, "bev": 1}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_modules, "DeformTransWorldFeat", functools.partial(jax_modules.DeformTransWorldFeat,
                                                                          dropout=0.0))
        return jax_loss_and_grads(jax_model, variables, batch, mesh=mesh)


def _spawn(axis, nproc, weights, out):
    port = _free_port()
    return [subprocess.Popen([sys.executable, WORKER, str(port), str(nproc), str(i), axis, str(out), str(weights)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(nproc)]


def _collect(procs, runs):
    try:
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


@pytest.fixture(scope="module")
def view_runs(tmp_path_factory, view_weights):
    """Every view run at once: ``{axis: (outdir, [stdout per rank])}``, and
    under ``"jax"`` JAX's view=2 step, computed while the workers run."""
    procs = {}
    for axis, nproc in PROCESSES.items():
        out = tmp_path_factory.mktemp(axis)
        procs[axis] = (out, _spawn(axis, nproc, view_weights[RUNS[axis][0]][1], out))
    runs = {}
    try:
        runs["jax"] = _jax_view_step(view_weights[4][0])
    except BaseException:
        _collect(procs, {})
        raise
    return _collect(procs, runs)


def _split_statistics(groups):
    """``BatchNorm2d.forward`` whose training statistics are those of view
    ranks in one process: the mean over ``groups`` (the rows of each rank)
    of each group's f32 means of x and x^2, as the ranks all-reduce them."""
    def forward(self, x):
        if not self.training:
            return self.__class__._plain_forward(self, x)
        x32 = x.float()
        means = [torch.stack([x32[g].mean(dim=(0, 2, 3)), (x32[g] * x32[g]).mean(dim=(0, 2, 3))]) for g in groups]
        total = means[0]
        for m in means[1:]:
            total = total + m
        mean, square = total / len(groups)
        var = torch.clamp(square - mean * mean, min=0.0)
        self._update_running_stats(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(self.dtype)

    return forward


def _one_process_step(path, num_cam, split_views=1, attn_mode="windowed"):
    """The one-process train step of the workers' global batch from the
    same weights and dropout generator, on one thread as the workers run
    (at the 3-camera rig's weights two threads alone move the gradients by
    ~2e-3: the trunk amplifies the reductions' rounding); with
    ``split_views`` the trunk's BatchNorm statistics split as that many view
    ranks split the cameras. Returns the loss and the gradients."""
    batch, state = tiny_setup(weights=torch.load(path), num_cam=num_cam, attn_mode=attn_mode)
    per = num_cam // split_views
    frames = batch["imgs"].shape[0]
    groups = [[b * num_cam + c for b in range(frames) for c in range(r * per, (r + 1) * per)]
              for r in range(split_views)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        if split_views > 1:
            mp.setattr(BatchNorm2d, "_plain_forward", BatchNorm2d.forward, raising=False)
            mp.setattr(BatchNorm2d, "forward", _split_statistics(groups))
        try:
            _, aux = train_step(state, batch, torch.Generator().manual_seed(STEP_SEED), device="cpu")
        finally:
            torch.set_num_threads(threads)
    return float(aux["loss"]), {n: p.grad.numpy() for n, p in state.model.named_parameters()}


def _grad_offs(record, grads):
    return {n: np.linalg.norm(record[f"grad:{n}"] - ref) / np.linalg.norm(ref) for n, ref in grads.items()}


@pytest.mark.parametrize("axis", list(PROCESSES))
def test_view_ranks_agree_and_match_the_one_process_step(axis, view_runs, view_weights):
    out, texts = view_runs[axis]
    cams, (views, bevs), _, attn_mode = RUNS[axis]
    nproc = PROCESSES[axis]
    shape = {"data": 1, "view": views, "bev": bevs}
    for rank, text in enumerate(texts):
        assert f"rank {rank}: mesh {shape}" in text
    steps = [np.load(out / f"step{rank}.npz") for rank in range(nproc)]
    for other in steps[1:]:
        assert other.files == steps[0].files and all(np.array_equal(steps[0][k], other[k]) for k in steps[0].files)
    path = view_weights[cams][1]
    loss, grads = _one_process_step(path, cams, attn_mode=attn_mode)
    np.testing.assert_allclose(float(steps[0]["aux:loss"]), loss, rtol=LOSS_RTOL)
    plain = _grad_offs(steps[0], grads)
    if axis == "view_idle":
        # every rank runs every camera: the one-process step's bits, the gradients neither summed over view nor
        # doubled
        assert "do not divide over it" in texts[0]
        assert max(plain.values()) == 0.0, sorted(plain.items(), key=lambda kv: -kv[1])[:5]
        return
    assert max(plain.values()) <= PLAIN_GRAD_RTOL, sorted(plain.items(), key=lambda kv: -kv[1])[:5]
    split = _grad_offs(steps[0], _one_process_step(path, cams, split_views=views, attn_mode=attn_mode)[1])
    assert max(split.values()) <= SPLIT_GRAD_RTOL, sorted(split.items(), key=lambda kv: -kv[1])[:5]


def test_view_step_matches_the_jax_view_sharded_step(view_runs, view_weights):
    """The view=2 step without dropout against JAX's on a view=2 mesh from
    the same weights (the tolerances of the port's one-process steps)."""
    out, _ = view_runs["view"]
    _, path = view_weights[4]
    ranks = [np.load(out / f"nodrop{rank}.npz") for rank in range(2)]
    assert all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0].files)
    aux = {k: float(ranks[0][f"aux:{k}"]) for k in LOSS_KEYS}
    state = {k: v.numpy() for k, v in torch.load(path).items()}
    state.update({k[len("grad:"):]: ranks[0][k] for k in ranks[0].files if k.startswith("grad:")})
    assert_step_matches((aux, flat(convert_reference_state_dict(state)["params"])), view_runs["jax"])


def test_view_cli_epoch_gives_the_same_loss_and_moda_on_both_ranks(view_runs):
    out, texts = view_runs["view"]
    for text in texts:
        assert "determinism check passed" in text and "mesh: {'data': 1, 'view': 2, 'bev': 1}" in text
    for prefix in ("Train epoch 1 done: loss", "Test: loss"):
        per_rank = [[re.sub(r", t [0-9.]+s$", "", line) for line in text.splitlines() if line.startswith(prefix)]
                    for text in texts]
        assert per_rank[0] and per_rank[0] == per_rank[1], prefix
    assert "moda" in [line for line in texts[0].splitlines() if line.startswith("Test: loss")][0]
    assert (out / "run" / "test.txt").is_file() and (out / "run" / "checkpoints" / "2" / "state.pt").is_file()


@pytest.mark.slow
def test_data_view_bev_in_eight_processes(tmp_path, view_weights):
    """data 2 x view 2 x bev 2 (`tests/test_parallel.py:128-155`'s mesh), 8
    gloo processes: the ranks agree bitwise and the step is the one-process
    step's within the split-statistics tolerance (statistics over data x
    view: 4 blocks of the frames' cameras)."""
    procs = {"data_view_bev": (tmp_path, _spawn("data_view_bev", 8, view_weights[4][1], tmp_path))}
    _, texts = _collect(procs, {})["data_view_bev"]
    steps = [np.load(tmp_path / f"step{rank}.npz") for rank in range(8)]
    for other in steps[1:]:
        assert all(np.array_equal(steps[0][k], other[k]) for k in steps[0].files)
    loss, grads = _one_process_step(view_weights[4][1], 4)
    np.testing.assert_allclose(float(steps[0]["aux:loss"]), loss, rtol=LOSS_RTOL)
    assert max(_grad_offs(steps[0], grads).values()) <= PLAIN_GRAD_RTOL
