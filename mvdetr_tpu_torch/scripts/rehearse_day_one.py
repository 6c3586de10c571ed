"""Full-scale day-one rehearsal: a reference checkpoint -> MODA on the card,
the port's twin of the repo's ``scripts/rehearse_day_one.py``.

Builds the complete day-one artifact set at Wildtrack scale and runs the
exact command a user will run the day real data exists:

1. a Wildtrack-format tree on disk (7 cameras, 1080x1920 PNG frames,
   calibration XMLs, annotations) written from a synthetic scene
   (``data/trees.py``);
2. a reference-format ``MultiviewDetector.pth`` at the full flagship
   configuration (``deform_trans``, bottleneck 128, 120x360 BEV): the port's
   parameter names are the reference checkpoint's, so a seeded port model's
   ``state_dict`` is a file of the same format (the JAX script builds it from
   the reference implementation, which the port does not carry);
3. ``cli.main(["-d", "wildtrack", "--data_root", <tree>, "--load_torch_ckpt",
   <pth>, "--attn_mode", "windowed", "--attn_radius", "8", ...])`` at batch
   1 (:func:`day_one_argv`): checkpoint reading and loading, the kornia
   warp convention, eval, CLEAR, the clip-fraction telemetry.

A random checkpoint gives a meaningless MODA by construction: the point is
that every stage of the real pipeline (adapter -> checkpoint -> eval on the
card) runs at full scale. Each stage's wall time is printed.

Usage: python -m mvdetr_tpu_torch.scripts.rehearse_day_one [--frames 8] [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

CHECKPOINT_SEED = 41


def write_tree(root: str, frames: int, persons: int = 16) -> None:
    from mvdetr_tpu_torch.data.trees import wildtrack_like_scene, write_wildtrack_tree

    write_wildtrack_tree(root, wildtrack_like_scene(num_frame=frames, num_person=persons))


def save_reference_checkpoint(path: str, rig, seed: int = CHECKPOINT_SEED, world_reduce: int = 4,
                              img_reduce: int = 12) -> float:
    """A seeded port model at the full flagship configuration on ``rig``,
    saved as the reference's ``MultiviewDetector.pth`` (its ``state_dict``
    under the reference's names); returns the file's size in MiB."""
    import torch

    from mvdetr_tpu_torch.models import MVDeTr

    model = MVDeTr.from_rig(rig, world_reduce=world_reduce, img_reduce=img_reduce, world_feat_arch="deform_trans",
                            bottleneck_dim=128, outfeat_dim=0, device="cpu", seed=seed)
    torch.save(model.state_dict(), path)
    return os.path.getsize(path) / 2**20


def day_one_argv(root: str, ckpt: str, attn_mode: str = "windowed", attn_radius: int = 8, device: str = "cuda",
                 world_reduce: int = 4, img_reduce: int = 12) -> list:
    """The day-one command's arguments: evaluate ``ckpt`` on the tree at
    ``root`` at batch 1."""
    return [
        "-d", "wildtrack",
        "--data_root", root,
        "--load_torch_ckpt", ckpt,
        "--attn_mode", attn_mode,
        "--attn_radius", str(attn_radius),
        "--epochs", "1",
        "--num_workers", "4",
        "--cls_thres", "0.3",
        "--batch_size", "1",
        "--world_reduce", str(world_reduce),
        "--img_reduce", str(img_reduce),
        "--device", device,
    ]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "day_one_rehearsal"))
    p.add_argument("--attn_mode", default="windowed")
    p.add_argument("--attn_radius", type=int, default=8)
    p.add_argument("--world_reduce", type=int, default=4, help="the BEV's reduction (4: the flagship's 120x360)")
    p.add_argument("--img_reduce", type=int, default=12)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from mvdetr_tpu_torch.data import WildtrackScene

    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    root = os.path.join(args.workdir, "Wildtrack")
    t0 = time.time()
    write_tree(root, args.frames)
    rig = WildtrackScene(root).rig
    print(f"[1/3] wrote Wildtrack-format tree ({args.frames * rig.num_cam} 1080x1920 PNGs) in "
          f"{time.time() - t0:.0f}s", flush=True)

    t0 = time.time()
    ckpt = os.path.join(args.workdir, "MultiviewDetector.pth")
    size_mb = save_reference_checkpoint(ckpt, rig, world_reduce=args.world_reduce, img_reduce=args.img_reduce)
    print(f"[2/3] built + saved full-scale reference-format checkpoint ({size_mb:.0f} MB) in {time.time() - t0:.0f}s",
          flush=True)

    from mvdetr_tpu_torch.cli import main as cli_main

    t0 = time.time()
    saved = sys.stdout
    try:
        trainer = cli_main(day_one_argv(root, ckpt, args.attn_mode, args.attn_radius, args.device,
                                        args.world_reduce, args.img_reduce)
                           + ["--logdir", os.path.join(args.workdir, "logs")])
    finally:
        if sys.stdout is not saved:  # the CLI tees stdout into its log
            sys.stdout.close()
            sys.stdout = saved
    print(f"[3/3] day-one eval command completed in {time.time() - t0:.0f}s "
          f"(attn {args.attn_mode} r{args.attn_radius}; incl. the kernels' build)", flush=True)
    return trainer


if __name__ == "__main__":
    main()
