"""Host time of the data path's stages for one camera at Wildtrack size, on
the host's CPU (no card needed):

    python -m mvdetr_tpu_torch.scripts.host_stages [--reps 5] [--threads 4]

Renders a 1080x1920 frame of the synthetic scene (``SyntheticScene.image``),
warps it by an augmentation affine (``native.warp_image_u8``), resizes it to
720x1280 (``native.resize_u8``) and builds its targets, each timed alone in
one thread (median of ``--reps``). Then ``--threads`` threads warp and
resize at once, which shows how far the native library scales without the
interpreter lock. Prints one line per stage in ms per camera and the CPU's
name; these are host times, not card times.
"""

from __future__ import annotations

import argparse
import platform
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from mvdetr_tpu_torch import native
from mvdetr_tpu_torch.data import SyntheticScene, build_targets, random_affine_matrix
from mvdetr_tpu_torch.geometry import make_synthetic_rig


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            return next(line.split(":", 1)[1].strip() for line in fh if line.startswith("model name"))
    except (OSError, StopIteration):
        return platform.processor() or "unknown CPU"


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args(argv)

    rig = make_synthetic_rig(num_cam=7, img_shape=(1080, 1920), worldgrid_shape=(480, 1440))
    scene = SyntheticScene(rig, num_frame=4, num_person=8, seed=2021, cache_images=False)
    img = scene.image(0, 0)
    M, _ = random_affine_matrix(img.shape[:2], np.random.default_rng(0))
    native.load_library()
    ms = {
        "render": median_ms(lambda: scene.image(1, 1), args.reps),
        "augment warp": median_ms(lambda: native.warp_image_u8(img, M), args.reps),
        "resize": median_ms(lambda: native.resize_u8(img, (720, 1280)), args.reps),
        "targets": median_ms(lambda: build_targets((90, 160), np.arange(8) * 200.0, np.arange(8) * 100.0,
                                                   np.full(8, 50.0), np.full(8, 150.0), np.arange(8), reduce=12,
                                                   top_k=100, kernel_size=10), args.reps),
    }
    n = args.threads * args.reps

    def warp_and_resize(_):
        native.resize_u8(native.warp_image_u8(img, M), (720, 1280))

    with ThreadPoolExecutor(args.threads) as pool:
        t0 = time.perf_counter()
        list(pool.map(warp_and_resize, range(n)))
        ms[f"warp + resize, {args.threads} threads, wall per camera"] = (time.perf_counter() - t0) * 1e3 / n
    print(f"host: {cpu_name()}, {args.reps} reps")
    for name, value in ms.items():
        print(f"{name}: {value:.2f} ms per camera")
    return ms


if __name__ == "__main__":
    main()
