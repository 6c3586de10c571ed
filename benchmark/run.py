"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout: ``BENCHMARK.json`` names the cell's
configuration (``benchmark/configs/<config>.json``) and traffic mix
(``benchmark/traffic/<mix>.json``). Measures ``mvdetr_tpu_torch`` on the
first CUDA device and exits non-zero without a result where there is none,
where the program cannot be imported, or where a JAX module
(``jax``, ``jaxlib``, ``flax``, ``optax``, ``mvdetr_tpu``) is loaded when the
run ends. The last lines on standard error, and the result's last key
``checks``, give each number compared with the reference beside its limit
(``benchmark/limits/<config>.json``).

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (``benchmark/metrics/<metric>.py``) from a profiled
sub-window after the window, with ``busy_s``, ``window_s`` and a
``breakdown`` of the device's top operations and longest idle gaps.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mvdetr_tpu")
HOST_THREADS = 2
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
CACHE_DIRS = {"TRITON_CACHE_DIR": ".bench_cache/triton", "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions"}


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", os.path.join(BENCH, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_spec(workload: str) -> tuple:
    """``(BENCHMARK.json, its cell, the configuration, the traffic mix,
    the limits or None)``."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"run.py: no workload {workload!r} in BENCHMARK.json")
    cfg = load_json(BENCH, "configs", f"{cell['config']}.json")
    traffic = load_json(BENCH, "traffic", f"{cell['traffic']}.json")
    limits_path = os.path.join(BENCH, "limits", f"{cell['config']}.json")
    limits = load_json(limits_path).get(traffic["kind"]) if os.path.exists(limits_path) else None
    return bench, cell, cfg, traffic, limits


def metrics_of(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_layers() -> dict:
    folder = os.path.join(BENCH, "layers")
    return {f[:-5]: load_json(folder, f) for f in sorted(os.listdir(folder)) if f.endswith(".json")}


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def trace_context(cfg: dict, traffic: dict) -> dict:
    from benchmark.harness import flops, inputs

    rig = inputs.rig_of(cfg)
    train = traffic["kind"] == "train"
    batch = traffic["batch_size"] if train else 1
    ctx = {"flops_per_unit": flops.count_flops(cfg, rig, batch, train),
           "attention_least_s": flops.attention_formula(cfg).least_step_seconds(cfg, batch, train)}
    if train:
        ctx["b3_least_s"] = flops.b3_least_seconds(cfg, batch)
    return ctx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, rel)
    for var in THREAD_VARS:  # one process with few threads: idle pool threads spinning on the cores add noise
        os.environ[var] = str(HOST_THREADS)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    bench, cell, cfg, traffic, limits = cell_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    import mvdetr_tpu_torch  # noqa: F401  (fails in a checkout without the program)

    from benchmark.harness import cells

    device = torch.device("cuda", 0)
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    run = cells.run_train if traffic["kind"] == "train" else cells.run_serve
    out = run(cfg, traffic, args.seed, args.seconds, bool(args.trace), device, T_START, load_layers(), limits)
    launches = {k: v for k, v in out.items() if k.startswith("launches_per")}
    print(f"kernel launches: {json.dumps(launches)}", file=sys.stderr, flush=True)

    if args.trace:
        rec, ctx = out["record"], trace_context(cfg, traffic)
        metrics = {}
        for m in metrics_of(bench["per_layer"], cell["name"]):
            value = load_reader(m["name"])(rec, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": rec["busy_s"], "window_s": rec["window_s"]}
        breakdown = {"device_ops": [list(x) for x in rec["device_ops"]], "idle_gaps": [list(x) for x in rec["idle_gaps"]]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench["end_to_end"], cell["name"])}
        extra, breakdown = {}, None

    found = forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                         "memory_peak_bytes": out["memory_peak_bytes"], **extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
