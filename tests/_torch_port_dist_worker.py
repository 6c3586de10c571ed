"""One rank of the port's 2-process CPU runs (`tests/test_torch_port_parallel.py`).

    python tests/_torch_port_dist_worker.py <port> <num_processes> <process_id> <axis> <outdir> <weights>

``axis`` is ``data`` (the batch over the processes), ``bev`` (the encoder's
BEV rows over them), ``view`` (the cameras of a 4-camera rig over them),
``view_idle`` (a 3-camera rig on a view axis of 2, which does not divide
it), ``view_gather`` (view 2 on the 4-camera rig in gather mode, whose
encoder runs replicated over view), ``view_bev`` (4 processes: view 2 x
bev 2 on the 4-camera rig) or ``data_view_bev`` (8 processes: data 2 x
view 2 x bev 2);
``weights`` is a state dict of the tiny model (of that rig) that every step
starts from. The rank joins the others over gloo on localhost; with
``bev`` it first runs the sharded windowed attention on :func:`attention_inputs`
(forward, and backward from a fixed cotangent) and writes the output and the
three gradients to ``<outdir>/attention<process_id>.npz``. It then takes one
sharded train step of the tiny model on its part of a fixed global batch of
2, at the model's dropout with a seeded generator, and writes the loss
terms, the gradients the optimizer applied (summed over the ranks), the
parameters after the step and a checksum of them to
``<outdir>/step<process_id>.npz``; with ``data`` also one such step without
dropout, the one JAX's sharded step can be held to, to
``<outdir>/nodrop<process_id>.npz``. Then it runs the CLI for one epoch and
its test with the multi-process flags (``--deterministic true``: the step is
first taken twice and must repeat bitwise); with ``view`` the step without
dropout too, and the CLI on the 4-camera rig with ``--view_shards 2``;
the other view runs take the step only. The CLI's lines go to
stdout; the test reads them from there.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mvdetr_tpu_torch import cli  # noqa: E402
from mvdetr_tpu_torch.ops.msda_sharded import bev_row_sharded_windowed_attention  # noqa: E402
from mvdetr_tpu_torch.parallel import initialize_distributed, make_mesh  # noqa: E402
from mvdetr_tpu_torch.parallel.collectives import checksum  # noqa: E402
from mvdetr_tpu_torch.parallel.sharding import make_sharded_train_step, shard_batch  # noqa: E402

# the CLI flags of tests/test_torch_port_cli.py's tiny run; its world grid gives an 8x16 encoder grid, so two BEV
# shards of 4 rows hold the radius-4 halo
TINY = ["-d", "synthetic", "--device", "cpu", "--synthetic_cams", "2", "--synthetic_frames", "6",
        "--synthetic_img", "48", "96", "--synthetic_grid", "32", "64", "--world_reduce", "2",
        "--cls_thres", "0.3", "--batch_size", "2", "-j", "1"]
STEP_SEED = 7
ATTENTION_RADIUS = 3
# per axis: the rig's cameras, the mesh's (view, bev) shards, whether the run takes the dropout-free step and the
# CLI, and the attention mode
RUNS = {"data": (2, (1, 1), True, "windowed"), "bev": (2, (1, 2), False, "windowed"),
        "view": (4, (2, 1), True, "windowed"), "view_idle": (3, (2, 1), False, "windowed"),
        "view_bev": (4, (2, 2), False, "windowed"), "data_view_bev": (4, (2, 2), False, "windowed"),
        "view_gather": (4, (2, 1), False, "gather")}


def attention_inputs():
    """Seeded value [1, 2, 8, 11, 2, 4], offsets past the clamp, weights
    and a cotangent of the output: two shards of 4 rows at radius 3."""
    rng = np.random.default_rng(5)
    r = ATTENTION_RADIUS
    value = rng.standard_normal((1, 2, 8, 11, 2, 4)).astype(np.float32)
    off = rng.uniform(-r - 1.5, r + 1.5, (1, 3, 8, 11, 2, 2, 3, 2)).astype(np.float32)
    wgt = rng.uniform(0.0, 1.0, (1, 3, 8, 11, 2, 2, 3)).astype(np.float32)
    g = rng.standard_normal((1, 3, 8, 11, 8)).astype(np.float32)
    return value, off, wgt, g


def tiny_setup(mesh=None, weights=None, dropout=0.1, num_cam=2, attn_mode="windowed"):
    """The tiny CLI run's first global training batch (unshuffled) and a
    fresh train state of its model on ``mesh`` at encoder ``dropout``, its
    parameters and statistics ``weights`` (a state dict) if given, on a rig
    of ``num_cam`` cameras, in ``attn_mode``."""
    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import create_train_state

    rig = make_synthetic_rig(num_cam=num_cam, img_shape=(48, 96), worldgrid_shape=(32, 64))
    scene = SyntheticScene(rig, num_frame=6, num_person=8, seed=2021)
    train_set = FrameDataset(scene, train=True, world_reduce=2, img_reduce=12, world_kernel_size=10,
                             img_kernel_size=10, seed=2021)
    batch = next(train_set.batches(2, shuffle=False))
    model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, device="cpu", seed=2021, mesh=mesh,
                            attn_mode=attn_mode, encoder_dropout=dropout)
    if weights is not None:
        model.load_state_dict(weights)
    return batch, create_train_state(model, lr=1e-3, total_steps=10)


def step_record(state, aux) -> dict:
    """What a test holds a step to: the loss terms (``aux:``), the gradients
    left in ``.grad`` (``grad:``, the ones the optimizer applied) and the
    parameters after it (``param:``)."""
    rec = {f"aux:{k}": v.numpy() for k, v in aux.items()}
    for name, p in state.model.named_parameters():
        rec[f"param:{name}"] = p.detach().numpy()
        rec[f"grad:{name}"] = p.grad.numpy()
    return rec


def main():
    port, nproc, pid, axis, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    weights = torch.load(sys.argv[6])
    torch.set_num_threads(1)
    address = f"localhost:{port}"
    initialize_distributed(address, nproc, pid, "cpu")
    cams, (views, bevs), full, attn_mode = RUNS[axis]
    mesh = make_mesh(num_view_shards=views, num_bev_shards=bevs)
    axes = ("data", "view", "bev")
    print(f"rank {pid}: mesh {mesh.shape} at {[mesh.index(a) for a in axes]}, groups "
          f"{[a for a in axes if mesh.group(a) is not None]}", flush=True)

    if axis == "bev":
        *inputs, g = (torch.from_numpy(a) for a in attention_inputs())
        inputs = [t.requires_grad_() for t in inputs]
        out = bev_row_sharded_windowed_attention(*inputs, mesh, radius=ATTENTION_RADIUS)
        out.backward(g)
        np.savez(os.path.join(outdir, f"attention{pid}.npz"), out=out.detach().numpy(),
                 **{name: t.grad.numpy() for name, t in zip(("g_value", "g_offsets", "g_weights"), inputs)})

    step = make_sharded_train_step(mesh)
    for name, dropout in (("step", 0.1), ("nodrop", 0.0))[:2 if full else 1]:
        batch, state = tiny_setup(mesh, weights, dropout, cams, attn_mode)
        _, aux = step(state, shard_batch(batch, mesh), torch.Generator().manual_seed(STEP_SEED), device="cpu")
        np.savez(os.path.join(outdir, f"{name}{pid}.npz"), checksum=np.int64(checksum(state.model)),
                 **step_record(state, aux))

    if full or axis == "bev":
        flags = ["--epochs", "1", "--deterministic", "true", "--num_processes", str(nproc), "--process_id",
                 str(pid), "--coordinator_address", address, "--logdir", os.path.join(outdir, "run"),
                 "--synthetic_cams", str(cams)]
        cli.main(TINY + flags + (["--bev_shards", str(bevs)] if bevs > 1 else [])
                 + (["--view_shards", str(views)] if views > 1 else []))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
