"""The readings that a cell's limits are set from, at the cell's own size,
in one process: for each seed the numbers of the sound program, of the
control (the reference in float8 put in the program's place) and of each
fault planted in the program.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control_seeds 1 2 3] [--fault_seeds 1 2 3] [--twin_seeds 1 2 3] [--seconds 3]

Training reads the first three steps of a train state built as a run
builds it; serving reads the answers of ``--seconds`` of the cell's
traffic. One JSON line a reading, then a summary: the largest sound
reading and the smallest control and fault reading of each number.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Readings of the program, the control and the faults.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    p.add_argument("--twin_seeds", type=int, nargs="*", default=[],
                   help="the reference in bf16 in the program's place: a second witness of the sound readings")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cells, check, faults, readings
    from benchmark.run import cell_spec

    _, cell, cfg, traffic, _ = cell_spec(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    train = traffic["kind"] == "train"
    rows = []

    def program(seed):
        return readings.program_numbers(cfg, traffic, seed, device, args.seconds)

    def control(seed):
        return readings.control_numbers(cfg, traffic, seed, device)

    def emit(kind, seed, numbers):
        rows.append((kind, numbers))
        print(json.dumps({"workload": cell["name"], "kind": kind, "seed": seed, **numbers}), flush=True)
        cells._free(device)

    for seed in args.seeds:
        emit("program", seed, program(seed))
    for seed in args.control_seeds:
        emit("control", seed, control(seed))
    for seed in args.twin_seeds:
        emit("bf16 reference", seed, readings.control_numbers(cfg, traffic, seed, device, "bf16"))
    for name in (("unchanged", "half_batch") if train else ("altered_answer",)):
        for seed in args.fault_seeds:
            with faults.planted(name):
                emit(f"fault:{name}", seed, program(seed))
    names = check.TRAIN_NUMBERS if train else check.SERVE_NUMBERS
    summary = {"workload": cell["name"], "summary": {}}
    for n in names:
        summary["summary"][n] = {kind: (max if kind == "program" else min)(r[n] for k, r in rows if k == kind)
                                 for kind in sorted({k for k, _ in rows})}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
