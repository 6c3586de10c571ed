"""Full-Wildtrack-scale training run on the card, the port's twin of the
repo's ``scripts/full_scale_run.py``.

Everything at Wildtrack scale, end to end through the day-one command:

1. writes a Wildtrack-format tree -- 7 cameras, 1080x1920 frames, the
   480x1440 ij grid (centimetres, offset origin), ``--frames`` frames, a
   30-person crowd -- from a synthetic scene (``data/trees.py``), its frames
   as PNGs rendered by a pool of spawned processes. Writing is resumable: a
   complete tree is reused and a frame already on disk is skipped;
2. measures the host input pipeline alone (disk decode, augmentation warp,
   resize, targets; frame-sets/s, no card), then runs ``python -m
   mvdetr_tpu_torch.cli -d wildtrack --data_root <tree>`` for the schedule
   (OneCycle over ``--epochs``), training on the 90% split and testing
   (decode, NMS, CLEAR) on the 10% hold-out after every epoch, one process
   per ``--epochs_per_process`` epochs continued by ``--resume_train``
   (``--stop_after N`` ends the run after N epochs of the schedule);
3. writes ``report.json``: MODA by epoch, train and test wall-clock per
   epoch, steady train frame-sets/s, the pipeline's rate and the peak
   device memory that the CLI's log reports.

Usage:
    python -m mvdetr_tpu_torch.scripts.full_scale_run --workdir DIR                  # 2000 frames, 10 epochs
    python -m mvdetr_tpu_torch.scripts.full_scale_run --workdir DIR --frames 200 --epochs 2
A 1080x1920 PNG of the synthetic scene takes ~4 MB: check the disk first.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NUM_CAM = 7
PNG_LEVEL = 1  # zlib's fastest: the synthetic frames' noise compresses ~4% less than at 6, in half the time


def make_scene(frames: int, persons: int, seed: int):
    from mvdetr_tpu_torch.data.trees import wildtrack_like_scene

    return wildtrack_like_scene(num_frame=frames, num_person=persons, seed=seed, cache_images=False)


def _render_chunk(job):
    """Worker: render and PNG-encode frames [lo, hi) of every camera."""
    root, frames, persons, seed, lo, hi = job
    from mvdetr_tpu_torch.data.png import write_png
    from mvdetr_tpu_torch.data.trees import image_path

    scene = make_scene(frames, persons, seed)
    for f in range(lo, hi):
        for cam in range(scene.rig.num_cam):
            path = image_path(root, cam, f)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"  # a killed writer leaves no partial frame under the real name
            write_png(tmp, scene.image(cam, f), PNG_LEVEL)
            os.replace(tmp, path)
    return hi - lo


def generate_tree(root: str, frames: int, persons: int, seed: int, procs: int) -> float:
    """Write the Wildtrack-format tree; returns the seconds it took (0 when a
    complete tree of the same scene is reused)."""
    from mvdetr_tpu_torch.data.trees import write_wildtrack_tree

    t0 = time.time()
    marker = os.path.join(root, ".complete")
    tag = f"{frames}x{persons}s{seed}png"
    if os.path.exists(marker) and open(marker).read().strip() == tag:
        print(f"[gen] reusing existing tree at {root}")
        return 0.0
    scene = make_scene(frames, persons, seed)
    write_wildtrack_tree(root, scene, with_images=False)  # calibrations and annotations, in-process
    for cam in range(NUM_CAM):
        os.makedirs(os.path.join(root, "Image_subsets", f"C{cam + 1}"), exist_ok=True)
    chunk = max(1, frames // (procs * 4))
    jobs = [(root, frames, persons, seed, lo, min(lo + chunk, frames)) for lo in range(0, frames, chunk)]
    done = 0
    with mp.get_context("spawn").Pool(procs) as pool:
        for n in pool.imap_unordered(_render_chunk, jobs):
            done += n
            print(f"[gen] {done}/{frames} frames rendered ({time.time() - t0:.0f}s)", flush=True)
    with open(marker, "w") as fh:
        fh.write(tag)
    return time.time() - t0


def measure_pipeline(root: str, batch_size: int, num_workers: int, n_batches: int = 12, **dataset_kw) -> float:
    """Host input-pipeline throughput (frame-sets/s): disk PNG decode,
    random affine, resize and targets, no card in the loop."""
    from mvdetr_tpu_torch.data import FrameDataset, open_scene

    scene = open_scene(root)
    ds = FrameDataset(scene, train=True, augmentation=True, **dataset_kw)

    def stream():
        while True:
            yield from ds.batches(batch_size, num_workers=num_workers)

    it = stream()
    next(it)  # warm: thread pool spin-up, first-touch IO
    t0 = time.time()
    n = 0
    for _ in range(n_batches):
        n += next(it)["imgs"].shape[0]
    return n / (time.time() - t0)


def parse_log(log: str) -> dict:
    """Per-epoch train seconds, test MODA and seconds, and the peak device
    memory lines of a CLI ``log.txt``."""
    train_ts = [float(m) for m in re.findall(r"Train epoch \d+ done: .*t ([\d.]+)s", log)]
    tests = re.findall(r"Test: loss [\d.]+, moda ([-\d.]+)%.*t ([\d.]+)s", log)
    peaks = [float(m) for m in re.findall(r"peak device memory ([\d.]+) GiB", log)]
    return {"train_s": train_ts, "moda": [float(m) for m, _ in tests], "eval_s": [float(t) for _, t in tests],
            "peak_gib": max(peaks) if peaks else None}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=2000)
    p.add_argument("--persons", type=int, default=30)
    p.add_argument("--scene_seed", type=int, default=5)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "full_scale"))
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=8e-4)
    p.add_argument("--base_lr_ratio", type=float, default=1.0)
    p.add_argument("--cls_thres", type=float, default=0.4)
    p.add_argument("--world_kernel_size", type=int, default=10)
    p.add_argument("--img_kernel_size", type=int, default=10)
    p.add_argument("--world_reduce", type=int, default=4)
    p.add_argument("--img_reduce", type=int, default=12)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--gen_procs", type=int, default=2)
    # bf16 is the mode the JAX package's run used (its f32 eval at batch 2 did not fit its device); the reference
    # trains in f32 (its autocast is commented out)
    p.add_argument("--bf16", default="true")
    p.add_argument("--epochs_per_process", type=int, default=1)
    p.add_argument("--stop_after", type=int, default=None,
                   help="stop after this many epochs of the --epochs schedule (resume later with --resume_train)")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    root = os.path.join(args.workdir, "Wildtrack")
    gen_s = generate_tree(root, args.frames, args.persons, args.scene_seed, args.gen_procs)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(os.path.join(root, "Image_subsets"))
               for f in fs) / 2**30
    print(f"[1/3] Wildtrack-format tree ready: {args.frames * NUM_CAM} 1080x1920 PNGs ({size:.2f} GiB), "
          f"480x1440 grid, {args.persons} persons ({gen_s:.0f}s)", flush=True)
    if args.skip_train:
        return {"gen_seconds": gen_s}

    dataset_kw = dict(world_kernel_size=args.world_kernel_size, img_kernel_size=args.img_kernel_size,
                      world_reduce=args.world_reduce, img_reduce=args.img_reduce)
    pipe_fs = measure_pipeline(root, args.batch_size, args.num_workers, **dataset_kw)
    print(f"[2/3] host input pipeline: {pipe_fs:.2f} frame-sets/s "
          f"({args.num_workers} workers, batch {args.batch_size})", flush=True)

    t0 = time.time()
    rundir = os.path.join(args.workdir, "run")
    shutil.rmtree(rundir, ignore_errors=True)
    base = [
        sys.executable, "-m", "mvdetr_tpu_torch.cli",
        "-d", "wildtrack",
        "--data_root", root,
        "--epochs", str(args.epochs),
        "-b", str(args.batch_size),
        "--lr", str(args.lr),
        "--base_lr_ratio", str(args.base_lr_ratio),
        "--cls_thres", str(args.cls_thres),
        "--world_kernel_size", str(args.world_kernel_size),
        "--img_kernel_size", str(args.img_kernel_size),
        "--world_reduce", str(args.world_reduce),
        "--img_reduce", str(args.img_reduce),
        "--num_workers", str(args.num_workers),
        "--bf16", str(args.bf16),
        "--epochs_per_process", str(args.epochs_per_process),
        "--device", args.device,
    ]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # one process per --epochs_per_process epochs; each restores the full train state (optimizer, schedule step)
    for launch in range(0, min(args.epochs, args.stop_after or args.epochs), args.epochs_per_process):
        cmd = base + (["--logdir", rundir] if launch == 0 else ["--resume_train", rundir])
        rc = subprocess.run(cmd, cwd=args.workdir, env=env).returncode
        if rc != 0:
            raise SystemExit(f"cli epoch process (launch {launch}) failed rc={rc}")
    total_s = time.time() - t0

    with open(os.path.join(rundir, "log.txt")) as fh:
        parsed = parse_log(fh.read())
    train_ts, modas = parsed["train_s"], parsed["moda"]
    if not train_ts:
        raise SystemExit(f"no 'Train epoch N done' line in {rundir}/log.txt")
    steady = sorted(train_ts[1:] or train_ts)
    steady_train = steady[len(steady) // 2]
    report = {
        "frames": args.frames,
        "train_frames": int(args.frames * 0.9),
        "epochs": args.epochs,
        "epochs_run": len(train_ts),
        "gen_seconds": round(gen_s, 1),
        "pipeline_fs_per_s": round(pipe_fs, 2),
        "epoch_train_seconds": [round(t, 1) for t in train_ts],
        "epoch_train_seconds_steady": round(steady_train, 1),
        "train_fs_per_s_steady": round(args.frames * 0.9 / steady_train, 2),
        "epoch_eval_seconds": [round(t, 1) for t in parsed["eval_s"]],
        "moda_per_epoch": modas,
        "final_moda": modas[-1] if modas else None,
        "best_moda": max(modas) if modas else None,
        "peak_hbm_gb": None if parsed["peak_gib"] is None else round(parsed["peak_gib"] * 2**30 / 1e9, 2),
        "total_seconds": round(total_s, 1),
    }
    print("[3/3] FULL-SCALE REPORT")
    print(json.dumps(report, indent=2))
    with open(os.path.join(args.workdir, "report.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    return report


if __name__ == "__main__":
    main()
