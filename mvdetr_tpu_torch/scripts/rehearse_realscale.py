"""Real-data dress rehearsal at full Wildtrack scale, the port's twin of the
repo's ``scripts/rehearse_realscale.py``.

A run on real data needs, per frame set, 7 decodes of 1080x1920 frames, the
augmentation warp and the resize on the host, feeding a 480x1440-grid model
on the card at the training rate. The device-resident benchmarks exercise
none of the host's part, so this script measures it:

1. writes N frame sets of the synthetic scene's 1080x1920 renders to disk as
   PNGs (``DiskPngScene``; the annotations stay the scene's). PNG is the
   port's disk format: its decoder is its own (``data/png.py``), so the card's
   machine, which has neither cv2 nor PIL, reads them; the JAX script wrote
   JPEGs through PIL;
2. runs the host input pipeline (decode + augmentation warp + resize +
   targets) over a sweep of loader threads (``--workers``) and prints the
   frame-sets/s and each stage's thread-ms per frame set;
3. with ``--train_steps``, takes that many full-scale train steps (480x1440
   grid, 720x1280 inputs, bf16) on the card fed by the disk pipeline through
   ``prefetch_to_device`` and ``train_step``, to expose starvation and
   memory pressure end to end.

Usage: python -m mvdetr_tpu_torch.scripts.rehearse_realscale [--frames 24] [--train_steps 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

RIG = dict(num_cam=7, img_shape=(1080, 1920), worldgrid_shape=(480, 1440), cell_meters=0.025, indexing="ij",
           worldcoord_unit=0.01, origin_offset=(-300.0, -900.0), camera_height_m=6.0, camera_margin_m=4.0,
           name="RehearseWildtrack")
STAGES = ("decode", "augment warp", "resize", "targets", "collate")


class DiskPngScene:
    """A scene source that serves a base scene's frames from PNG files on
    disk, decoded by ``data/adapters.py::load_image_rgb`` as a real
    dataset's frames are; the annotations are the base scene's."""

    def __init__(self, base, root: str, workers: int = 8):
        from mvdetr_tpu_torch.data.png import write_png

        self.rig = base.rig
        self.num_frame = base.num_frame
        self._base = base
        os.makedirs(root, exist_ok=True)
        t0 = time.time()
        self._paths = {(cam, frame): os.path.join(root, f"c{cam}_f{frame:05d}.png")
                       for frame in base.frames() for cam in range(base.rig.num_cam)}

        def write(key):
            if not os.path.exists(self._paths[key]):
                write_png(self._paths[key], base.image(*key))

        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(write, self._paths))
        n = len(self._paths)
        size = sum(os.path.getsize(p) for p in self._paths.values()) / 1e6
        print(f"materialized {n} PNGs ({size:.0f} MB, {size / n:.2f} MB each) in {time.time() - t0:.1f}s")

    def frames(self):
        return self._base.frames()

    def annotation(self, frame):
        return self._base.annotation(frame)

    def image(self, cam, frame):
        from mvdetr_tpu_torch.data.adapters import load_image_rgb

        return load_image_rgb(self._paths[(cam, frame)])


@contextlib.contextmanager
def host_stage_clock():
    """Thread-seconds by data stage while the block runs: the decode, the
    augmentation warp and the resize (native library), the targets and the
    collation. Yields the dict of seconds by stage; the wrapped functions
    are put back on exit."""
    from mvdetr_tpu_torch import native
    from mvdetr_tpu_torch.data import adapters, dataset

    seconds = dict.fromkeys(STAGES, 0.0)
    lock = threading.Lock()
    patched = [(adapters, "load_image_rgb", "decode"), (native, "warp_image_u8", "augment warp"),
               (native, "resize_u8", "resize"), (dataset, "build_targets", "targets"),
               (dataset, "collate", "collate")]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patched]

    def timed(fn, stage):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                with lock:
                    seconds[stage] += time.perf_counter() - t0
        return wrapper

    for (owner, name, stage), (_, _, fn) in zip(patched, saved):
        setattr(owner, name, timed(fn, stage))
    try:
        yield seconds
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def pipeline_sweep(ds, batch: int, workers) -> dict:
    """Frame-sets/s and thread-ms per frame set by stage of one pass over
    ``ds`` at each loader thread count."""
    out = {}
    for nw in workers:
        with host_stage_clock() as seconds:
            t0 = time.time()
            count = 0
            for b in ds.batches(batch, num_workers=nw):
                count += b["imgs"].shape[0]
            dt = time.time() - t0
        ms = {k: v * 1e3 / max(count, 1) for k, v in seconds.items()}
        out[nw] = {"frame_sets_per_s": count / dt, "thread_ms_per_frame_set": ms}
        stages = ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
        print(f"  num_workers={nw:3d}: {count / dt:6.2f} frame-sets/s host ({dt / max(count, 1) * 1000:.0f} "
              f"ms/frame-set); thread-ms per frame set: {stages}", flush=True)
    return out


def train_steps(rig, ds, batch: int, n_steps: int, device: str) -> dict:
    """``n_steps`` full-scale train steps (bf16) fed by the disk pipeline;
    returns the first step's seconds and the steady ms per step."""
    import torch

    from mvdetr_tpu_torch.data.prefetch import prefetch_to_device
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import create_train_state, train_step

    print("building full-scale model (480x1440 grid, 720x1280 inputs)...")
    model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, world_feat_arch="deform_trans",
                            compute_dtype=torch.bfloat16, device=device)
    state = create_train_state(model, lr=5e-4, total_steps=100)
    generator = torch.Generator(device=device).manual_seed(0)
    steps, t_first, aux = 0, None, None
    t0 = time.time()
    it = ds.batches(batch, num_workers=8)
    for b in prefetch_to_device(it, device, size=2):
        state, aux = train_step(state, b, generator, device=device)
        if steps == 0:
            float(aux["loss"])  # barrier: the first step builds the kernels and warms the allocator
            t_first = time.time() - t0
            t0 = time.time()
        steps += 1
        if steps > n_steps:
            break
    loss = float(aux["loss"])
    dt = (time.time() - t0) / max(steps - 1, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30 if torch.device(device).type == "cuda" else float("nan")
    print(f"first step {t_first:.1f}s; steady-state {dt * 1000:.0f} ms/step with the DISK pipeline = "
          f"{batch / dt:.2f} frame-sets/s; last loss {loss:.4f}; peak device memory {peak:.2f} GiB", flush=True)
    return {"first_step_s": t_first, "ms_per_step": dt * 1e3, "frame_sets_per_s": batch / dt, "loss": loss,
            "peak_gib": peak}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--workers", type=int, nargs="+", default=[0, 4, 8, 16])
    p.add_argument("--root", type=str, default=os.path.join(tempfile.gettempdir(), "rehearse_wildtrack"))
    p.add_argument("--train_steps", type=int, default=0,
                   help="also run this many real train steps at full scale on the device")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
    from mvdetr_tpu_torch.geometry import make_synthetic_rig

    rig = make_synthetic_rig(**RIG)
    base = SyntheticScene(rig, num_frame=args.frames, num_person=20, seed=0, cache_images=False)
    scene = DiskPngScene(base, args.root)
    ds = FrameDataset(scene, train=True, world_reduce=4, img_reduce=12, top_k=100, augmentation=True)

    print(f"host input pipeline, {len(ds)} frame-sets on disk, batch {args.batch}:")
    result = {"pipeline": pipeline_sweep(ds, args.batch, args.workers)}
    if args.train_steps:
        result["train"] = train_steps(rig, ds, args.batch, args.train_steps, args.device)
    return result


if __name__ == "__main__":
    main()
