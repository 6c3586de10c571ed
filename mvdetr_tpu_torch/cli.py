"""Experiment runner, port of ``mvdetr_tpu/cli.py`` (the original MVDeTr's
``main.py``).

Trains epoch after epoch from a dataset, tests with CLEAR after each epoch,
checkpoints the full train state, and writes ``log.txt`` (a tee of stdout),
``test.txt`` (the last test's detections), ``checkpoints/<step>/`` and a
snapshot of the package's source into a config-encoded logdir
(`main.py:77-89`). ``--resume <name>`` reloads the weights of a run and
tests them; ``--resume_train <logdir>`` restores the full state and
continues the epoch loop; ``--epochs_per_process N`` stops after N epochs.

The parser is the JAX package's, flag for flag and default for default,
plus ``--device`` (default ``cuda``; the run raises without a card unless
``--device cpu``). ``--visualize`` writes the last test batch's figures
into ``logdir/visualize`` after every test (one process only, as in JAX;
without matplotlib one line says which figures were skipped).

Several processes (`mvdetr_tpu/cli.py:141-144,181-226`): ``--num_processes
N --process_id i --coordinator_address host:port`` joins N processes (gloo
with ``--device cpu``, NCCL with ``cuda``, one GPU per process; more
processes on a host than GPUs raise before any work), and the mesh is laid
out as JAX lays it: ``--view_shards`` processes along the cameras (each runs
the trunk, the warp and the windowed encoder's query blocks of its cameras;
the cameras must divide, else the axis is idle and says so) times
``--bev_shards`` along the BEV rows, the rest along ``data``, as many as
divide the batch. Every process must be part of
the mesh, else the run raises before any work. The logdir is then
``..._mh{N}_seed{seed}`` on every process; rank 0 writes ``log.txt``, the
source snapshot, ``test.txt`` and the checkpoints. Every fusion variant
(``--world_feat``), both backbones (``--arch``, with ``--backbone_ckpt``
read as torchvision's weights of that backbone), ``--remat_backbone``,
``--n_points 8`` (the shadow reference maps, ``warped`` attention) and
``--attn_mode windowed|warped|gather`` run.
``--reID`` and ``--id_ratio`` are accepted and, as in the JAX package, only
name the logdir.

``--load_torch_ckpt MultiviewDetector.pth`` evaluates a reference checkpoint
once and trains nothing (`mvdetr_tpu/cli.py:228-241,299-326`): its
configuration must match the flags (else the run exits with the flags to
pass), ``--warp_convention`` defaults to ``kornia`` (the reference's
resampling), and outside ``--attn_mode gather`` an unset ``--attn_radius``
is picked from the checkpoint's offset biases.

Usage::

    python -m mvdetr_tpu_torch.cli -d synthetic --epochs 10 --synthetic_frames 12 --lr 1e-3 --cls_thres 0.4
    python -m mvdetr_tpu_torch.cli -d synthetic --device cpu --epochs 1 --synthetic_frames 4
    python -m mvdetr_tpu_torch.cli -d synthetic --n_points 8 --epochs 10 --synthetic_frames 12 --lr 1e-3 --cls_thres 0.4
    python -m mvdetr_tpu_torch.cli -d synthetic --attn_mode gather --epochs 10 --synthetic_frames 12 --lr 1e-3
    python -m mvdetr_tpu_torch.cli -d synthetic --world_feat deform_conv --arch vgg11 --epochs 2 --synthetic_frames 12
    python -m mvdetr_tpu_torch.cli -d synthetic --synthetic_frames 12 --load_torch_ckpt MultiviewDetector.pth
    # two processes on the CPU, the 16 encoder rows of a 128x256 grid over both (leave out --bev_shards for data
    # parallelism at -b 2)
    python -m mvdetr_tpu_torch.cli -d synthetic --device cpu -b 2 --synthetic_grid 128 256 --bev_shards 2 \
        --num_processes 2 --process_id 0 --coordinator_address localhost:29500 &
    python -m mvdetr_tpu_torch.cli -d synthetic --device cpu -b 2 --synthetic_grid 128 256 --bev_shards 2 \
        --num_processes 2 --process_id 1 --coordinator_address localhost:29500
    # the 4 cameras over two processes (view ranks), and the figures of one process's test
    python -m mvdetr_tpu_torch.cli -d synthetic --device cpu --synthetic_cams 4 --view_shards 2 \
        --num_processes 2 --process_id 0 --coordinator_address localhost:29501 &
    python -m mvdetr_tpu_torch.cli -d synthetic --device cpu --synthetic_cams 4 --view_shards 2 \
        --num_processes 2 --process_id 1 --coordinator_address localhost:29501
    python -m mvdetr_tpu_torch.cli -d synthetic --device cpu --epochs 1 --synthetic_frames 4 --visualize
"""

from __future__ import annotations

import argparse
import datetime
import importlib.util
import os
import shutil
import sys


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Multiview detector on the GPU (PyTorch + CUDA)")
    parser.add_argument("--reID", action="store_true")
    parser.add_argument("--semi_supervised", type=float, default=0)
    parser.add_argument("--id_ratio", type=float, default=0)
    parser.add_argument("--cls_thres", type=float, default=0.6)
    parser.add_argument("--alpha", type=float, default=1.0, help="ratio for per view loss")
    parser.add_argument("--use_mse", type=str2bool, default=False)
    parser.add_argument("--arch", type=str, default="resnet18", choices=["vgg11", "resnet18"])
    parser.add_argument("-d", "--dataset", type=str, default="wildtrack",
                        choices=["wildtrack", "multiviewx", "synthetic"])
    parser.add_argument("-j", "--num_workers", type=int, default=4)
    parser.add_argument("-b", "--batch_size", type=int, default=1)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--dropcam", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--base_lr_ratio", type=float, default=0.1)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--resume_train", type=str, default=None,
                        help="logdir (path or logs/<dataset>/<name>) to restore the FULL train state "
                             "(parameters, optimizer, schedule, step) from and continue the epoch loop")
    parser.add_argument("--epochs_per_process", type=int, default=None,
                        help="stop after N epochs this process (checkpoint saved); rerun with "
                             "--resume_train to continue")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of epoch-1 steps 2-4 to logdir/trace")
    parser.add_argument("--seed", type=int, default=2021)
    parser.add_argument("--deterministic", type=str2bool, default=False)
    parser.add_argument("--augmentation", type=str2bool, default=True)
    parser.add_argument("--world_feat", type=str, default="deform_trans",
                        choices=["conv", "trans", "deform_conv", "deform_trans", "aio"])
    parser.add_argument("--bottleneck_dim", type=int, default=128)
    parser.add_argument("--outfeat_dim", type=int, default=0)
    parser.add_argument("--world_reduce", type=int, default=4)
    parser.add_argument("--world_kernel_size", type=int, default=10)
    parser.add_argument("--img_reduce", type=int, default=12)
    parser.add_argument("--img_kernel_size", type=int, default=10)
    parser.add_argument("--view_shards", type=int, default=1, help="processes along the view (camera) axis")
    parser.add_argument("--bev_shards", type=int, default=1, help="processes along the BEV-row axis")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of rank 0's rendezvous, with --num_processes > 1")
    parser.add_argument("--num_processes", type=int, default=None, help="processes of the run, one device each")
    parser.add_argument("--process_id", type=int, default=None, help="this process's rank")
    parser.add_argument("--bf16", type=str2bool, default=False, help="bfloat16 compute (params stay f32)")
    parser.add_argument("--attn_mode", type=str, default="auto", choices=["auto", "gather", "windowed", "warped"],
                        help="deformable-attention sampling; auto = windowed for n_points 4, warped for 8; "
                             "gather = the reference semantics, unclamped")
    parser.add_argument("--n_points", type=int, default=4, choices=[4, 8],
                        help="deformable points per (head, level); 8 = shadow reference maps")
    parser.add_argument("--attn_radius", type=int, default=None,
                        help="windowed-attention clamp radius in BEV cells (default 4, or picked from "
                             "--load_torch_ckpt)")
    parser.add_argument("--nms_top_k", type=int, default=512,
                        help="eval candidate cap before NMS (the trainer warns when it saturates)")
    parser.add_argument("--remat_backbone", type=str2bool, default=False,
                        help="rematerialize backbone blocks on backward (memory for compute)")
    parser.add_argument("--backbone_ckpt", type=str, default=None,
                        help="torchvision resnet18 (or, with --arch vgg11, vgg11) .pth/.npz for ImageNet init")
    parser.add_argument("--load_torch_ckpt", type=str, default=None,
                        help="reference MultiviewDetector.pth, eval only")
    parser.add_argument("--warp_convention", type=str, default=None, choices=["center", "kornia"],
                        help="BEV warp sampling convention; default 'center' ('kornia' with --load_torch_ckpt)")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--logdir", type=str, default=None,
                        help="explicit run directory (overrides the config-encoded name)")
    # synthetic-scene sizing (dataset == synthetic only)
    parser.add_argument("--synthetic_cams", type=int, default=4)
    parser.add_argument("--synthetic_frames", type=int, default=60)
    parser.add_argument("--synthetic_img", type=int, nargs=2, default=(180, 320))
    parser.add_argument("--synthetic_grid", type=int, nargs=2, default=(120, 240))
    # the port's addition
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs; 'cuda' raises without a card")
    return parser


def resolve_mesh(args):
    """The mesh of JAX's CLI (`mvdetr_tpu/cli.py:211-226`) over this run's
    processes, or None for one process without sharding: ``--view_shards x
    --bev_shards`` processes a data row, and as many data rows as the
    processes allow and the batch divides into. Raises ``ValueError`` unless
    the mesh spans every process (JAX would leave the others idle)."""
    import torch.distributed as dist

    from mvdetr_tpu_torch.parallel import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.view_shards <= 1 and args.bev_shards <= 1 and world <= 1:
        return None
    per = args.view_shards * args.bev_shards
    data_size = max(1, min(world // per, args.batch_size))
    while args.batch_size % data_size:
        data_size -= 1
    usable = data_size * per
    if usable != world:
        raise ValueError(f"{world} process(es) do not form the mesh data={data_size} x view={args.view_shards} x "
                         f"bev={args.bev_shards} (batch {args.batch_size}): run {usable} processes "
                         f"(--num_processes {usable})")
    return make_mesh(num_view_shards=args.view_shards, num_bev_shards=args.bev_shards) if usable > 1 else None


def main(args=None):
    args = build_parser().parse_args(args)

    import numpy as np
    import torch

    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene, open_scene
    from mvdetr_tpu_torch.device import resolve_device
    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.parallel import initialize_distributed
    from mvdetr_tpu_torch.train import (
        Trainer, create_train_state, restore_checkpoint, restore_weights, save_checkpoint,
    )
    from mvdetr_tpu_torch.utils.logger import Logger

    multihost = bool(args.num_processes and args.num_processes > 1)
    device = resolve_device(args.device)
    if multihost:
        device = initialize_distributed(args.coordinator_address, args.num_processes, args.process_id, device)
    mesh = resolve_mesh(args)
    rank0 = mesh is None or mesh.rank == 0
    if args.deterministic:  # as the original MVDeTr's --deterministic (`main.py:43-46`)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    if args.dataset == "synthetic":
        rig = make_synthetic_rig(
            num_cam=args.synthetic_cams,
            img_shape=tuple(args.synthetic_img),
            worldgrid_shape=tuple(args.synthetic_grid),
        )
        scene = SyntheticScene(rig, num_frame=args.synthetic_frames, num_person=8, seed=args.seed)
    else:
        scene = open_scene(args.data_root or args.dataset)
        rig = scene.rig

    common = dict(
        world_reduce=args.world_reduce, img_reduce=args.img_reduce,
        world_kernel_size=args.world_kernel_size, img_kernel_size=args.img_kernel_size,
        seed=args.seed,
    )
    train_set = FrameDataset(scene, train=True, semi_supervised=args.semi_supervised,
                             dropout=args.dropcam, augmentation=args.augmentation, **common)
    test_set = FrameDataset(scene, train=False, **common)

    # logdir convention (`main.py:77-89`). Several processes resolve one directory: a tag from the seed replaces
    # the per-process timestamp, and rank 0 alone writes the tee and the snapshot (`mvdetr_tpu/cli.py:181-205`)
    if args.resume_train is not None:
        logdir = (args.resume_train if os.path.isdir(args.resume_train)
                  else f"logs/{args.dataset}/{args.resume_train}")
        if rank0:
            sys.stdout = Logger(os.path.join(logdir, "log.txt"), append=True)
    elif args.resume is None:
        if args.logdir is not None:
            logdir = args.logdir
        else:
            stamp = (f"mh{args.num_processes}_seed{args.seed}" if multihost
                     else f"{datetime.datetime.today():%Y-%m-%d_%H-%M-%S}")
            logdir = (
                f"logs/{args.dataset}/{'SS_' if args.semi_supervised else ''}"
                f"{'aug_' if args.augmentation else ''}{args.world_feat}_lr{args.lr}_baseR{args.base_lr_ratio}_"
                f"neck{args.bottleneck_dim}_out{args.outfeat_dim}_"
                f"alpha{args.alpha}_id{args.id_ratio}_drop{args.dropout}_dropcam{args.dropcam}_"
                f"worldRK{args.world_reduce}_{args.world_kernel_size}_imgRK{args.img_reduce}_{args.img_kernel_size}_"
                f"{stamp}"
            )
        # the multi-process tag is the same for the same config and seed: a second such run shares the directory
        if multihost and args.logdir is None and os.path.isdir(os.path.join(logdir, "checkpoints")):
            print(f"WARNING: multihost logdir {logdir} already contains checkpoints from a previous run with the "
                  f"same config+seed; resuming picks the latest step across BOTH runs. Pass --logdir for a fresh "
                  f"directory.")
        os.makedirs(logdir, exist_ok=True)
        if rank0:
            _snapshot_source(logdir)
            sys.stdout = Logger(os.path.join(logdir, "log.txt"))
    else:
        logdir = f"logs/{args.dataset}/{args.resume}"
    print(logdir)
    print("Settings:")
    print(vars(args))
    if mesh is not None:
        print(f"mesh: {mesh.shape}")

    # windowed clamp radius: the flag, else for a reference checkpoint (trained with unbounded offsets) the
    # smallest radius that covers its offsets' biases, else 4 (`mvdetr_tpu/cli.py:228-241`)
    attn_radius = args.attn_radius
    if attn_radius is None and args.load_torch_ckpt and args.attn_mode != "gather":
        from mvdetr_tpu_torch.interop import read_torch_checkpoint, suggest_attn_radius

        attn_radius, reach = suggest_attn_radius(read_torch_checkpoint(args.load_torch_ckpt))
        print(f"auto attn_radius {attn_radius} (checkpoint max |sampling_offsets bias| "
              f"{reach:.2f} cells; override with --attn_radius N, exact semantics with "
              f"--attn_mode gather)")
    if attn_radius is None:
        attn_radius = 4

    model = MVDeTr.from_rig(
        rig, world_reduce=args.world_reduce, img_reduce=args.img_reduce, arch=args.arch,
        world_feat_arch=args.world_feat, bottleneck_dim=args.bottleneck_dim,
        outfeat_dim=args.outfeat_dim, dropout=args.dropout,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        attn_mode=args.attn_mode, attn_radius=attn_radius, n_points=args.n_points,
        warp_convention=args.warp_convention or ("kornia" if args.load_torch_ckpt else "center"),
        remat_backbone=args.remat_backbone, device=device, seed=args.seed, mesh=mesh,
    )

    backbone_vars = None
    if args.backbone_ckpt:
        if args.backbone_ckpt.endswith(".npz"):
            backbone_vars = dict(np.load(args.backbone_ckpt))
        else:
            backbone_vars = torch.load(args.backbone_ckpt, map_location="cpu", weights_only=True)

    steps_per_epoch = train_set.steps_per_epoch(args.batch_size)
    state = create_train_state(
        model, lr=args.lr, total_steps=steps_per_epoch * args.epochs, base_lr_ratio=args.base_lr_ratio,
        weight_decay=args.weight_decay, backbone_variables=backbone_vars,
    )

    trainer = Trainer(state, train_set, test_set, cls_thres=args.cls_thres, alpha=args.alpha,
                      use_mse=args.use_mse, nms_top_k=args.nms_top_k, num_workers=args.num_workers,
                      profile_dir=os.path.join(logdir, "trace") if args.profile else None, seed=args.seed,
                      mesh=mesh)
    res_fpath = os.path.join(logdir, "test.txt")
    ckpt_dir = os.path.join(logdir, "checkpoints")
    visualize_dir = os.path.join(logdir, "visualize") if args.visualize else None

    if args.deterministic:
        trainer.check_determinism(batch_size=args.batch_size)

    history = {"epoch": [], "train_loss": [], "test_loss": [], "moda": []}
    start_epoch = 1
    if args.resume_train:
        restore_checkpoint(ckpt_dir, trainer.state)
        start_epoch = trainer.state.step // steps_per_epoch + 1
        print(f"resume_train: restored step {trainer.state.step} "
              f"-> continuing at epoch {start_epoch}/{args.epochs}")
    if args.load_torch_ckpt:
        _load_reference_checkpoint(args, trainer.state.model)
    elif args.resume is None:
        draw = importlib.util.find_spec("matplotlib") is not None
        if not draw:
            print("NOTE: matplotlib is not installed; no learning_curve.jpg is drawn")
        for epoch in range(start_epoch, args.epochs + 1):
            print(f"=== epoch {epoch}/{args.epochs} ===")
            train_loss = trainer.train_epoch(epoch, batch_size=args.batch_size)
            test_loss, moda, modp, prec, recall = trainer.test(batch_size=args.batch_size, res_fpath=res_fpath,
                                                               visualize_dir=visualize_dir)
            history["epoch"].append(epoch)
            history["train_loss"].append(train_loss)
            history["test_loss"].append(test_loss)
            history["moda"].append(moda)
            if rank0:
                save_checkpoint(ckpt_dir, trainer.state)
                if draw:
                    _draw_curve(os.path.join(logdir, "learning_curve.jpg"), history)
            if mesh is not None:
                torch.distributed.barrier()  # the checkpoint is on disk before any rank goes on
            if (args.epochs_per_process and epoch < args.epochs
                    and epoch - start_epoch + 1 >= args.epochs_per_process):
                print(f"epochs_per_process budget reached at epoch {epoch}; "
                      f"continue with --resume_train {logdir}")
                return trainer
    else:
        restore_weights(ckpt_dir, trainer.state)
        if args.profile:
            print("NOTE: --profile has no effect with --resume (the training loop is skipped)")
    print("Test loaded model...")
    trainer.test(batch_size=args.batch_size, res_fpath=res_fpath, visualize_dir=visualize_dir)
    return trainer


def _load_reference_checkpoint(args, model) -> None:
    """``--load_torch_ckpt``: check the checkpoint's configuration against
    the flags (a mismatch exits with the flags to pass), then load it into
    ``model`` strictly (`mvdetr_tpu/cli.py:299-326`)."""
    from mvdetr_tpu_torch.interop import detect_reference_config, read_torch_checkpoint
    from mvdetr_tpu_torch.train.state import load_state_dict_checked

    print(f"Loading reference torch checkpoint {args.load_torch_ckpt} (eval only)")
    if args.attn_mode not in ("gather",):
        print("NOTE: reference checkpoints train with unbounded offsets; "
              "--attn_mode gather is reference-exact (slow). The fast paths clamp "
              "offsets to --attn_radius — watch the offset_clip_fraction diagnostic.")
    sd = read_torch_checkpoint(args.load_torch_ckpt)
    ckpt_cfg = detect_reference_config(sd)
    flag_cfg = {"arch": args.arch, "world_feat_arch": args.world_feat,
                "bottleneck_dim": args.bottleneck_dim, "outfeat_dim": args.outfeat_dim,
                "n_points": args.n_points}
    mismatched = {k: (flag_cfg[k], v) for k, v in ckpt_cfg.items()
                  if k in flag_cfg and flag_cfg[k] != v}
    if mismatched:
        flags = {"arch": "--arch", "world_feat_arch": "--world_feat",
                 "bottleneck_dim": "--bottleneck_dim", "outfeat_dim": "--outfeat_dim",
                 "n_points": "--n_points"}
        hint = " ".join(f"{flags[k]} {v}" for k, (_, v) in mismatched.items())
        raise SystemExit(
            f"checkpoint config mismatch {mismatched} (flag value, checkpoint value); "
            f"rerun with: {hint}"
        )
    load_state_dict_checked(model, sd, what="reference checkpoint")


def _snapshot_source(logdir: str) -> None:
    """Copy the package source into ``logdir/scripts`` so every run records
    the exact code it ran (`main.py:84-88`); built libraries and caches are
    left out."""
    src = os.path.dirname(os.path.abspath(__file__))
    dst = os.path.join(logdir, "scripts", "mvdetr_tpu_torch")
    try:
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "_build"), dirs_exist_ok=True)
    except OSError as e:  # best effort (read-only file system, ...), and said so
        print(f"NOTE: source snapshot into {dst} failed: {e}")


def _draw_curve(path: str, history: dict) -> None:
    """Per-epoch loss/MODA plot (`utils/draw_curve.py:7-18`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax1 = plt.subplots()
    ax1.plot(history["epoch"], history["train_loss"], "b-", label="train loss")
    ax1.plot(history["epoch"], history["test_loss"], "r-", label="test loss")
    ax1.legend(loc="upper left")
    ax2 = ax1.twinx()
    ax2.plot(history["epoch"], history["moda"], "g-", label="MODA %")
    ax2.legend(loc="upper right")
    fig.savefig(path)
    plt.close(fig)


if __name__ == "__main__":
    main()
