"""Harder synthetic accuracy benchmark with a tuned recipe, the port's twin of
the repo's ``scripts/hard_benchmark.py`` (same rig, scene, datasets, model,
recipe, panel and exit rule; the port's weights are other random draws).

The scene is denser and more occluded than ``tests/test_convergence.py``
(24 people against 8, a bigger grid) but has adequate camera coverage (6
cameras at 3.5 m), unlike the clamp-stress scene (``stress_ab``, 4 cameras
at 2 m), which measures clamp differentials, not absolute accuracy.

Run the pinned recipe:      python -m mvdetr_tpu_torch.scripts.hard_benchmark
Three-seed panel:           python -m mvdetr_tpu_torch.scripts.hard_benchmark --panel
Sweep learning rates:       python -m mvdetr_tpu_torch.scripts.hard_benchmark --sweep
On the CPU:                 add --device cpu (the default, cuda, raises without a card)

The pinned recipe exits 1 if MODA < --floor (88), the panel if its worst
seed is under --panel_floor (85).
"""

from __future__ import annotations

import argparse
import sys
import time

# the rig and scene: 6 cameras at 3.5 m over a 6.4 x 12.8 m grid (2.5 cm cells), 60 frames. The 0.5 m NMS radius and
# CLEAR threshold are 20 cells, so people must be spaced plausibly in metres or greedy NMS deletes true positives.
RIG = dict(num_cam=6, img_shape=(270, 480), worldgrid_shape=(256, 512), camera_height_m=3.5, camera_margin_m=2.0,
           name="HardBench")
NUM_FRAME = 60
PANEL_SEEDS = (5, 7, 11)


def build_data(seed: int = 5, num_person: int = 24, kernel: float = 4.0, augmentation: bool = True):
    """The benchmark's rig, scene and train / test datasets."""
    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
    from mvdetr_tpu_torch.geometry import make_synthetic_rig

    rig = make_synthetic_rig(**RIG)
    scene = SyntheticScene(rig, num_frame=NUM_FRAME, num_person=num_person, seed=seed)
    kw = dict(world_reduce=4, img_reduce=12, top_k=48, world_kernel_size=kernel, img_kernel_size=kernel)
    train_set = FrameDataset(scene, train=True, augmentation=augmentation, **kw)
    test_set = FrameDataset(scene, train=False, **kw)
    return rig, scene, train_set, test_set


def run(lr=8e-4, epochs=15, n_points=4, seed=5, batch_size=2, cls_thres=0.35, kernel=4.0, base_lr_ratio=1.0,
        augmentation=True, quiet=False, num_person=24, bottleneck=128, attn_mode="auto", attn_radius=4,
        device="cuda") -> dict:
    """Train and test the recipe; returns ``moda``, ``modp``, ``precision``,
    ``recall`` and ``seconds`` (the wall time of training and tests)."""
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import Trainer, create_train_state

    rig, _, train_set, test_set = build_data(seed, num_person, kernel, augmentation)
    model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, world_feat_arch="deform_trans",
                            bottleneck_dim=bottleneck, n_points=n_points, attn_mode=attn_mode,
                            attn_radius=attn_radius, device=device)
    steps = (len(train_set) // batch_size) * epochs
    state = create_train_state(model, lr=lr, total_steps=steps, base_lr_ratio=base_lr_ratio)
    trainer = Trainer(state, train_set, test_set, cls_thres=cls_thres,
                      logger=(lambda *a: None) if quiet else print)
    t0 = time.time()
    for ep in range(1, epochs + 1):
        loss = trainer.train_epoch(ep, batch_size=batch_size, log_interval=1000)
        if ep % 3 == 0 or ep == epochs:
            _, moda, modp, prec, rec = trainer.test(batch_size=2)
            print(f"lr={lr:g} p={n_points} epoch {ep:2d}: loss {loss:.4f} "
                  f"moda {moda:5.1f} prec {prec:5.1f} rec {rec:5.1f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    _, moda, modp, prec, rec = trainer.test(batch_size=2)
    seconds = time.time() - t0
    print(f"FINAL lr={lr:g} n_points={n_points}: moda {moda:.1f} modp {modp:.1f} "
          f"prec {prec:.1f} recall {rec:.1f} ({seconds:.1f}s, {trainer.state.model.world_feat.mode} attention, "
          f"{trainer.device})", flush=True)
    return {"moda": moda, "modp": modp, "precision": prec, "recall": rec, "seconds": seconds}


def panel(args) -> dict:
    """The same recipe over PANEL_SEEDS, gated on the worst seed: the scene's
    difficulty varies with the seed (density and occlusion), so the honest
    number is the band and the worst seed."""
    results = {}
    for seed in PANEL_SEEDS:
        moda = run(lr=args.lr, epochs=args.epochs, n_points=args.n_points, quiet=True, cls_thres=args.cls_thres,
                   num_person=args.num_person, seed=seed, attn_mode=args.attn_mode, attn_radius=args.attn_radius,
                   device=args.device)["moda"]
        results[seed] = moda
        print(f"PANEL seed {seed}: moda {moda:.1f}", flush=True)
    worst = min(results.values())
    print(f"PANEL band: {worst:.1f}-{max(results.values()):.1f} over seeds {dict(results)}")
    if worst < args.panel_floor:
        print(f"REGRESSION: worst-seed moda {worst:.1f} < panel floor {args.panel_floor}")
        sys.exit(1)
    print(f"OK: worst-seed moda {worst:.1f} >= panel floor {args.panel_floor}")
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--panel", action="store_true", help="3-seed panel with a worst-seed floor")
    p.add_argument("--lr", type=float, default=8e-4)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--n_points", type=int, default=4)
    p.add_argument("--floor", type=float, default=88.0)
    p.add_argument("--panel_floor", type=float, default=85.0)
    p.add_argument("--cls_thres", type=float, default=0.35)
    p.add_argument("--num_person", type=int, default=24)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--attn_mode", default="auto", choices=["auto", "gather", "windowed", "warped"],
                   help="A/B the attention modes on the same recipe")
    p.add_argument("--attn_radius", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.panel:
        return panel(args)
    if args.sweep:
        return {lr: run(lr=lr, epochs=args.epochs, n_points=args.n_points, quiet=True, cls_thres=args.cls_thres,
                        num_person=args.num_person, device=args.device) for lr in (8e-4, 1.2e-3)}
    result = run(lr=args.lr, epochs=args.epochs, n_points=args.n_points, quiet=True, cls_thres=args.cls_thres,
                 num_person=args.num_person, seed=args.seed, attn_mode=args.attn_mode,
                 attn_radius=args.attn_radius, device=args.device)
    if result["moda"] < args.floor:
        print(f"REGRESSION: moda {result['moda']:.1f} < floor {args.floor}")
        sys.exit(1)
    print(f"OK: moda {result['moda']:.1f} >= floor {args.floor}")
    return result


if __name__ == "__main__":
    main()
