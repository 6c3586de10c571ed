"""The host syncs of a cell's request or train step at full size, by the
Python line that made them (``torch.cuda.set_sync_debug_mode``), and the NMS
fixed point's passes among them (``distance_nms.passes``). No cell's run loads
this file: it is run by hand, on a card.

    python3 benchmark/probes/sync_probe.py --workload <cell> [--seed N] [--units 3]

Run from the root of a checkout. Prints one JSON line: syncs and NMS passes
a unit, and syncs a unit by file and line.
"""

import argparse
import collections
import json
import os
import sys
import traceback
import warnings

ROOT = os.getcwd()  # the tree to measure
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import torch  # noqa: E402

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import cells, inputs  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2147400777)
    p.add_argument("--units", type=int, default=3)
    args = p.parse_args()
    _, _, cfg, traffic, _ = bench_run.cell_spec(args.workload)
    device = torch.device("cuda", 0)
    train = traffic["kind"] == "train"
    if train:
        run = cells.TrainRun(cfg, traffic, args.seed, device)
        run.first_steps()
        unit = run.step
    else:
        run = cells.ServeRun(cfg, traffic, args.seed, device)
        run.serve(inputs.schedule(traffic, run.seeds.schedule + 2, cells.WARMUP_S), keep_answers=False)
        unit = lambda: run.request(0)  # noqa: E731
    torch.cuda.synchronize()
    from mvdetr_tpu_torch.ops.nms import distance_nms

    where = collections.Counter()
    p0 = distance_nms.passes
    for _ in range(args.units):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            unit()
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        for w in got:
            where[f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"] += 1
    n = args.units
    print(json.dumps({"workload": args.workload, "units": n, "syncs_a_unit": sum(where.values()) / n,
                      "nms_passes_a_unit": (distance_nms.passes - p0) / n,
                      "by_line": {k: v / n for k, v in where.most_common()}}), flush=True)
    if train:
        run.close()


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
