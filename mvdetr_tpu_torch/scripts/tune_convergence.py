"""Synthetic convergence tuning, the port's twin of the repo's
``scripts/tune_convergence.py`` (same flags, defaults and recipe).

Runs the flagship pipeline on the xy and ij rigs of
``tests/test_convergence.py`` (4 cameras, 180x320 frames, a 120x240 grid;
the ij rig in Wildtrack's conventions: ij indexing, centimetres, an offset
origin) and prints each epoch's loss and the final MODA, MODP, precision
and recall, so the floors the convergence test asserts can be set with
evidence.

Usage: python -m mvdetr_tpu_torch.scripts.tune_convergence [--indexing xy|ij] [--epochs 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

RIGS = {
    "xy": dict(num_cam=4, img_shape=(180, 320), worldgrid_shape=(120, 240)),
    "ij": dict(num_cam=4, img_shape=(180, 320), worldgrid_shape=(120, 240), cell_meters=0.025, indexing="ij",
               worldcoord_unit=0.01, origin_offset=(-150.0, -450.0), name="SyntheticWildtrackBig"),
}


def run(indexing, epochs, lr, num_frame, num_person, seed, cls_thres, kernel, batch_size=2, base_lr_ratio=1.0,
        augmentation=False, attn_radius=4, device="cuda") -> dict:
    from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene
    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import Trainer, create_train_state

    rig = make_synthetic_rig(**RIGS[indexing])
    scene = SyntheticScene(rig, num_frame=num_frame, num_person=num_person, seed=seed)
    kw = dict(world_reduce=2, img_reduce=12, top_k=16, world_kernel_size=kernel, img_kernel_size=kernel)
    train_set = FrameDataset(scene, train=True, augmentation=augmentation, **kw)
    test_set = FrameDataset(scene, train=False, **kw)

    model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, world_feat_arch="deform_trans", bottleneck_dim=64,
                            attn_radius=attn_radius, device=device)
    steps = (len(train_set) // batch_size) * epochs
    state = create_train_state(model, lr=lr, total_steps=steps, base_lr_ratio=base_lr_ratio)
    trainer = Trainer(state, train_set, test_set, cls_thres=cls_thres, logger=lambda *a: None)
    t0 = time.time()
    losses = []
    for ep in range(1, epochs + 1):
        losses.append(trainer.train_epoch(ep, batch_size=batch_size))
        print(f"[{indexing}] epoch {ep}: loss {losses[-1]:.4f} ({time.time() - t0:.0f}s)", flush=True)
    _, moda, modp, precision, recall = trainer.test(batch_size=1)
    print(f"[{indexing}] FINAL moda {moda:.1f} modp {modp:.1f} prec {precision:.1f} recall {recall:.1f}",
          flush=True)
    return {"losses": losses, "moda": moda, "modp": modp, "precision": precision, "recall": recall}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--indexing", default="xy", choices=sorted(RIGS))
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num_frame", type=int, default=40)
    p.add_argument("--num_person", type=int, default=6)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--cls_thres", type=float, default=0.4)
    p.add_argument("--kernel", type=float, default=4.0)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--attn_radius", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    return run(a.indexing, a.epochs, a.lr, a.num_frame, a.num_person, a.seed, a.cls_thres, a.kernel,
               batch_size=a.batch_size, attn_radius=a.attn_radius, device=a.device)


if __name__ == "__main__":
    main()
