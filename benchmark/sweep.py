"""The knee of a serving cell: the highest offered rate at which the
program's backlog does not grow over the window.

    python3 benchmark/sweep.py --workload <serve cell> --seed <n> --seconds <s> --rates 20 25 30

One set-up, then for each rate the cell's open-loop schedule at that rate
for ``--seconds``: its p50 and p95 latency, the completed rate, and the
backlog's growth (the mean latency of the last quarter of the requests less
that of the first). The knee is the highest rate whose growth stays within
the arrivals' jitter (``jitter_ms``); the cell offers 0.8 of it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Sweep a serving cell's offered rate.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.run import HOST_THREADS, THREAD_VARS, cell_spec

    for var in THREAD_VARS:  # the process as run.py sets it up
        os.environ[var] = str(HOST_THREADS)
    import torch

    from benchmark.harness import cells, inputs

    torch.set_num_threads(HOST_THREADS)

    _, cell, cfg, traffic, _ = cell_spec(args.workload)
    if traffic["kind"] != "serve" or not torch.cuda.is_available():
        raise SystemExit("sweep.py: a serving cell on a CUDA device")
    device = torch.device("cuda", 0)
    run = cells.ServeRun(cfg, traffic, args.seed, device)
    run.serve(inputs.schedule(traffic, run.seeds.schedule + 2, cells.WARMUP_S), keep_answers=False)
    cells._settle(device)
    rows = []
    for rate in args.rates:
        plan = inputs.schedule(traffic, run.seeds.schedule, args.seconds, rate=rate)
        t0 = time.perf_counter()
        served = run.serve(plan, keep_answers=False)
        lat = (served["end"] - served["due"]) * 1e3
        service = (served["end"] - served["start"]) * 1e3
        q = max(1, len(lat) // 4)
        rows.append({"rate_per_s": rate, "requests": len(lat), "p50_ms": float(np.percentile(lat, 50)),
                     "p95_ms": float(np.percentile(lat, 95)), "service_median_ms": float(np.median(service)),
                     "completed_per_s": len(lat) / (time.perf_counter() - t0),
                     "backlog_growth_ms": float(lat[-q:].mean() - lat[:q].mean())})
        print(json.dumps(rows[-1]), flush=True)
    steady = [r for r in rows if r["backlog_growth_ms"] < traffic["jitter_ms"]]
    knee = max((r["rate_per_s"] for r in steady), default=None)
    print(json.dumps({"workload": cell["name"], "knee_per_s": knee,
                      "offered_per_s": None if knee is None else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
