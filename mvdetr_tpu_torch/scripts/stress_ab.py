"""Windowed-clamp stress A/B, the port's twin of the repo's
``scripts/stress_ab.py`` (same scene, datasets, model and recipe).

The easy synthetic benchmark saturates at the same MODA for windowed and
gather attention, which says nothing about the radius-4 clamp under stress.
This script builds a deliberately hard scene -- a dense crowd and low
cameras (long shadows across the BEV grid, heavy occlusion) -- and A/Bs:

  - windowed (offsets clamped to radius 4) against gather (unbounded
    offsets, the reference semantics),
  - 4 points (identity references) against 8 (shadow reference maps; in
    windowed mode 8 points run ``warped``).

Prints each configuration's final MODA, MODP, precision and recall and the
trained offset-clip fraction (the share of learned offsets the clamp bites
on), taken from one probe train step on a copy of the trained state.

Usage: python -m mvdetr_tpu_torch.scripts.stress_ab [--epochs 10] [--modes windowed gather] [--points 4 8]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import time

# low cameras -> shadows stretch far across the BEV plane; dense crowd -> occlusion: where a too-tight clamp starves
# the attention's reach
RIG = dict(num_cam=4, img_shape=(96, 160), worldgrid_shape=(48, 96), camera_height_m=2.0, camera_margin_m=1.0,
           name="Stress")
NUM_FRAME, NUM_PERSON = 40, 20


def build_data(seed: int = 3):
    """The stress scene's rig, scene and train / test datasets."""
    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
    from mvdetr_tpu_torch.geometry import make_synthetic_rig

    rig = make_synthetic_rig(**RIG)
    scene = SyntheticScene(rig, num_frame=NUM_FRAME, num_person=NUM_PERSON, seed=seed)
    kw = dict(world_reduce=2, img_reduce=12, top_k=32, world_kernel_size=4, img_kernel_size=4)
    train_set = FrameDataset(scene, train=True, augmentation=True, **kw)
    test_set = FrameDataset(scene, train=False, **kw)
    return rig, scene, train_set, test_set


def run(mode: str, n_points: int, epochs: int, seed: int = 3, device: str = "cuda") -> dict:
    """Train and test one configuration; returns ``moda``, ``modp``,
    ``precision``, ``recall``, ``clip_frac`` and ``seconds``."""
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import Trainer, create_train_state, train_step

    rig, _, train_set, test_set = build_data(seed)
    model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, world_feat_arch="deform_trans", bottleneck_dim=64,
                            attn_mode=mode, n_points=n_points, device=device)
    steps = (len(train_set) // 2) * epochs
    state = create_train_state(model, lr=1e-3, total_steps=steps, base_lr_ratio=1.0)
    trainer = Trainer(state, train_set, test_set, cls_thres=0.4, logger=lambda *a: None)
    t0 = time.time()
    for ep in range(1, epochs + 1):
        trainer.train_epoch(ep, batch_size=2)
    # the final clip fraction from one probe step (the aux the CLI logs), on a copy: the test sees the trained state
    batches = trainer._batches(2)
    probe = next(batches)
    batches.close()
    _, aux = train_step(copy.deepcopy(trainer.state), probe, trainer.step_generator(0), device=trainer.device)
    clip = float(aux["offset_clip_fraction"]) if "offset_clip_fraction" in aux else float("nan")
    _, moda, modp, precision, recall = trainer.test(batch_size=1)
    seconds = time.time() - t0
    label = f"{mode}/P{n_points}"
    print(f"{label:16s} moda {moda:5.1f}  modp {modp:5.1f}  prec {precision:5.1f}  "
          f"recall {recall:5.1f}  clip_frac {clip:.4f}  ({seconds:.0f}s)", flush=True)
    return {"moda": moda, "modp": modp, "precision": precision, "recall": recall, "clip_frac": clip,
            "seconds": seconds}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--modes", nargs="+", default=["windowed", "gather"])
    p.add_argument("--points", type=int, nargs="+", default=[4])
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    print(f"stress scene: {RIG['num_cam']} cams at {RIG['camera_height_m']} m height, {NUM_PERSON} people on a "
          f"{RIG['worldgrid_shape'][0]}x{RIG['worldgrid_shape'][1]} BEV grid, occlusion")
    results = {}
    for n_points in a.points:
        for mode in a.modes:
            if n_points == 8 and mode == "windowed":
                mode = "warped"  # 8-point shadow references take the warped path
            results[f"{mode}/P{n_points}"] = run(mode, n_points, a.epochs, a.seed, a.device)
    return results


if __name__ == "__main__":
    main()
