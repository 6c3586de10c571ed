"""The flagship train step of this tree against another checkout of the
repository, on the card, in turns.

    python -m mvdetr_tpu_torch.scripts.step_vs_tree OTHER_ROOT [--steps 6] [--rounds 1] [--profile PATH]
        [--n_points 4|8] [--attn_mode auto|gather]

``OTHER_ROOT`` is a checkout of the repository, for instance another commit
unpacked with ``git archive`` into the git-ignored ``.checkout/``. A round
runs this tree, the other, the other again and this again, so that drift
over the call weighs on both alike. Each run is a process of its own, from
the tree's root: it builds that tree's kernels, then takes one warm-up and
``--steps`` timed train steps of the flagship at full width (``chip_smoke.py``'s
bench rig and batch: 7 cameras, 720x1280 frames, bf16, batch 2; ``--n_points
8``: the shadow configuration, warped attention over 56 pseudo-levels;
``--attn_mode gather``: gather attention, the reference MVDeTr's, whose
value gradients are B3 launches at gather's coordinates) and prints
one JSON line: the median step, the timed steps and the last loss. The
card's name and power limit come first. Raises without a card.

With ``--profile PATH`` each run then takes one more step under
``torch.profiler`` and reports its device time by kernel name (with
``chip_smoke.device_activities`` of its tree); the tables of every run go
to ``PATH`` as JSON, and the kernels whose device time differs most
between the two trees' first runs are printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHILD = """
import json, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.train import batch_to_device, create_train_state, train_step
rig = cs.bench_rig()
batch = batch_to_device(cs.train_batch(rig, 2, world_reduce=4, img_reduce=12, seed=0), "cuda")
model = MVDeTr.from_rig(rig, world_reduce=4, img_reduce=12, compute_dtype=torch.bfloat16, attn_radius=4,
                        n_points={n_points}, attn_mode="{attn_mode}", device="cuda", seed=0)
state = create_train_state(model, lr=cs.LR, total_steps=cs.TOTAL_STEPS)
gen = torch.Generator(device="cuda").manual_seed(0)
times = []
for _ in range(1 + {steps}):
    t0 = time.perf_counter()
    _, aux = train_step(state, batch, gen)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
print("STEP " + json.dumps({{"median_ms": float(np.median(times[1:])), "times_ms": times[1:],
                             "loss": float(aux["loss"])}}))
if {profile}:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(state, batch, gen)
        torch.cuda.synchronize()
    table = {{e.key: [e.count, e.self_device_time_total / 1e3] for e in cs.device_activities(prof)}}
    print("PROFILE " + json.dumps(table))
"""


def run(root: str, steps: int, profile: bool = False, n_points: int = 4, attn_mode: str = "auto") -> tuple:
    """One run of the step in ``root``: its STEP record and, with
    ``profile``, its device time by kernel name ``{name: [count, ms]}``."""
    proc = subprocess.run([sys.executable, "-c", CHILD.format(steps=steps, profile=profile, n_points=n_points,
                                                              attn_mode=attn_mode)],
                          cwd=root,
                          capture_output=True, text=True, timeout=900)
    lines = {tag: [line[len(tag):] for line in proc.stdout.splitlines() if line.startswith(tag)]
             for tag in ("STEP ", "PROFILE ")}
    if proc.returncode != 0 or not lines["STEP "] or (profile and not lines["PROFILE "]):
        raise RuntimeError(f"the step in {root} failed (rc {proc.returncode}):\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(lines["STEP "][-1]), json.loads(lines["PROFILE "][-1]) if profile else None


def print_profile_difference(this: dict, other: dict, top: int = 16) -> None:
    """The device time of each tree's profiled step, and the kernels whose
    time differs most between them (this minus other)."""
    total = {label: sum(ms for _, ms in table.values()) for label, table in (("this", this), ("other", other))}
    print(f"profiled step, device ms: this {total['this']:.3f}, other {total['other']:.3f}")
    keys = sorted(set(this) | set(other),
                  key=lambda k: -abs(this.get(k, [0, 0.0])[1] - other.get(k, [0, 0.0])[1]))
    for k in keys[:top]:
        (nt, mt), (no, mo) = this.get(k, [0, 0.0]), other.get(k, [0, 0.0])
        print(f"  {mt - mo:+9.3f} ms  this {mt:8.3f} ({nt:4d}x)  other {mo:8.3f} ({no:4d}x)  {k[:100]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="root of another checkout of the repository")
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--profile", metavar="PATH", help="profile one more step of each run; tables to PATH")
    parser.add_argument("--n_points", type=int, choices=(4, 8), default=4,
                        help="8: the shadow configuration (warped attention)")
    parser.add_argument("--attn_mode", choices=("auto", "gather"), default="auto",
                        help="gather: gather attention (B3 for each encoder layer's value gradient)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("step_vs_tree times the card: no CUDA device is available")
    other = os.path.abspath(args.other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    medians = {"this": [], "other": []}
    profiles = []
    for _ in range(args.rounds):
        for label in ("this", "other", "other", "this"):
            rec, table = run(ROOT if label == "this" else other, args.steps, profile=bool(args.profile),
                             n_points=args.n_points, attn_mode=args.attn_mode)
            medians[label].append(rec["median_ms"])
            profiles.append({"tree": label, "card": smi, "device_ms_by_kernel": table})
            print(json.dumps({"tree": label, "root": ROOT if label == "this" else other, **rec}), flush=True)
    if args.profile:
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)), exist_ok=True)
        with open(args.profile, "w") as f:
            json.dump(profiles, f)
        first = {p["tree"]: p["device_ms_by_kernel"] for p in reversed(profiles)}
        print_profile_difference(first["this"], first["other"])
    print(json.dumps({"median_of_medians_ms": {k: float(np.median(v)) for k, v in medians.items()},
                      "medians_ms": medians, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
