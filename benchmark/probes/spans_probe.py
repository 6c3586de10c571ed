"""The program's ``mvdetr:*`` spans read as a span-aware trace reduction
would read them, beside the hook metrics of the same traced window, and
what the spans and the hooks cost, in turns in one process. No cell's run
loads this file: it is run by hand.

    python3 benchmark/probes/spans_probe.py --workload <cell> --seed N [--turns 2] [--tiny]

Run from the root of a checkout: the tree it measures (``--tiny``: the
benchmark tests' tiny configuration on the CPU, to try the probe without
a card; its device readings are then empty). Each turn traces the
cell's sub-window (3 steps or 30 requests) six ways, in an order that turns
round every turn: spans and hooks, ``span`` stubbed with the hooks, spans
alone, neither, and untraced with and without spans. The profiler records
every thread (the feed's producer too). The reduction renames each
``mvdetr:<span>`` host annotation to ``bench:span_<layer>`` and reduces the
trace again with the harness's own ``reduce_trace``: kernels launched
inside it, backward nodes by autograd's sequence numbers, host durations.
``eval_idle_ms`` is each ``mvdetr:eval_step`` interval less the union of
device activity inside it; ``idle_ms_by_span`` names each device idle gap
of the window by the innermost ``mvdetr:*`` span on the main thread at the
gap's middle. stderr has one JSON line of readings a turn; stdout the
summary: milliseconds a unit by variant, and the readings of every turn.
"""

import argparse
import contextlib
import functools
import json
import os
import sys
import time

ROOT = os.getcwd()  # the tree to measure
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import cells, inputs, trace  # noqa: E402
from benchmark.harness.trace import HOST_CATS, layer_seconds  # noqa: E402

SPAN_LAYERS = {"mvdetr:trunk": "span_trunk", "mvdetr:norm": "span_norm", "mvdetr:warp": "span_warp",
               "mvdetr:attention": "span_attention", "mvdetr:upload": "span_upload", "mvdetr:eval_step": "span_eval",
               "mvdetr:feed.stage": "span_feed_stage", "mvdetr:feed.wait": "span_feed_wait"}
SPAN_MODULES = ("mvdetr_tpu_torch.models.layers", "mvdetr_tpu_torch.models.deformable",
                "mvdetr_tpu_torch.models.mvdetr", "mvdetr_tpu_torch.train.trainer", "mvdetr_tpu_torch.data.prefetch")
NULL = contextlib.nullcontext()


def stub(name):
    return NULL


def set_spans(on: bool):
    import importlib

    from mvdetr_tpu_torch.utils.profiling import span

    for m in SPAN_MODULES:
        mod = importlib.import_module(m)
        if hasattr(mod, "span"):
            mod.span = span if on else stub


def nms_passes():
    from mvdetr_tpu_torch.ops.nms import distance_nms

    return getattr(distance_nms, "passes", None)


_captured = {}
_orig_reduce = trace.reduce_trace


def _capture(events, layers):
    _captured["events"] = events
    return _orig_reduce(events, layers)


def install():
    """Keep each traced window's events for :func:`span_readings`, and have
    the harness's profiler record every thread (torch records no host op of
    another thread without ``profile_all_threads``)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "2"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache/triton")
    torch.set_num_threads(2)
    trace.reduce_trace = _capture
    try:
        from torch.profiler import _ExperimentalConfig
    except ImportError:
        return
    torch.profiler.profile = functools.partial(torch.profiler.profile,
                                               experimental_config=_ExperimentalConfig(profile_all_threads=True))


def union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def span_readings(events, rec) -> dict:
    """The span twins of the hook metrics, the feed's and the eval step's
    readings and the idle time by span, from ``events`` renamed as the
    module docstring says; ``rec`` is the harness's reduction of the same
    window (its units, device intervals and hook layers)."""
    renamed = [dict(e, name="bench:" + SPAN_LAYERS[e["name"]])
               if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("name") in SPAN_LAYERS else e
               for e in events]
    r2 = _orig_reduce(renamed, {})
    u = rec["units"]
    out = {}

    def dev(layer, **kw):
        s = layer_seconds(r2, layer, **kw)
        return 1e3 * s / u if s > 0 else None

    out["span_device_ms.trunk"] = dev("span_trunk", minus=("span_norm",))
    out["span_device_ms.norm"] = dev("span_norm")
    out["span_device_ms.attention"] = dev("span_attention")
    out["span_device_ms.warp"] = dev("span_warp")
    out["span_h2d_ms"] = dev("span_upload", cat="gpu_memcpy", name_part="HtoD")
    hs = r2["host_spans"]
    out["feed_wait_ms"] = sum(hs["span_feed_wait"]) / 1e3 / u if hs.get("span_feed_wait") else None
    out["feed_stage_ms"] = (sum(hs["span_feed_stage"]) / len(hs["span_feed_stage"]) / 1e3
                            if hs.get("span_feed_stage") else None)
    out["feed_counts"] = [len(hs.get("span_feed_stage", [])), len(hs.get("span_feed_wait", []))]
    # eval idle: each eval_step interval minus the union of device activity inside it
    evals = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("name") == "mvdetr:eval_step"]
    segs = union([(ts, ts + dur) for _, ts, dur, _ in rec["device"]])
    idle = []
    for a, b in evals:
        busy = sum(max(0.0, min(b, y) - max(a, x)) for x, y in segs)
        idle.append((b - a) - busy)
    out["eval_idle_ms"] = sum(idle) / len(idle) / 1e3 if idle else None
    out["eval_span_ms"] = sum(b - a for a, b in evals) / len(evals) / 1e3 if evals else None
    # the window's idle time by the innermost mvdetr span on the main thread at each gap's middle
    win = next(e for e in events if e.get("ph") == "X" and e.get("name") == "bench:window")
    w0, w1, main = win["ts"], win["ts"] + win["dur"], win["tid"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("tid") == main
                    and str(e.get("name", "")).startswith("mvdetr:")), key=lambda t: (t[0], -t[1]))
    gaps, last = [], w0
    for a, b in [s_ for s_ in segs if s_[1] >= w0 and s_[0] <= w1] + [(w1, w1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    by_span, named = {}, []
    for a, b in gaps:
        mid = (a + b) / 2
        enclosing = [t for t in spans if t[0] <= mid <= t[1]]
        name = min(enclosing, key=lambda t: t[1] - t[0])[2] if enclosing else "(none)"
        by_span[name] = by_span.get(name, 0.0) + (b - a) / 1e3 / u
        named.append((name, (b - a) / 1e3))
    out["idle_ms_by_span"] = {k: round(v, 4) for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])}
    out["longest_gaps_in_a_unit"] = sorted([g for g in named if g[0] != "(none)"], key=lambda g: -g[1])[:10]
    out["gap_count_by_span"] = {k: sum(1 for g in named if g[0] == k) for k in by_span}
    # the hook metrics of the same trace, for the twins
    out["hook.device_ms.trunk"] = 1e3 * layer_seconds(rec, "trunk", minus=("normalisation",)) / u
    out["hook.device_ms.norm"] = 1e3 * layer_seconds(rec, "normalisation") / u
    out["hook.device_ms.attention"] = 1e3 * layer_seconds(rec, "attention") / u
    out["hook.h2d_ms"] = 1e3 * layer_seconds(rec, "upload", cat="gpu_memcpy", name_part="HtoD") / u
    out["hook.B3_ms"] = 1e3 * layer_seconds(rec, "warp_backward") / u
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1234567891)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args()
    install()
    bench, cell, cfg, traffic, limits = bench_run.cell_spec(args.workload)
    if args.tiny:
        from benchmark.tests import _tiny

        mode = cfg["attn_mode"]
        cfg = _tiny.config(mode)
        traffic = _tiny.train_traffic() if traffic["kind"] == "train" else _tiny.serve_traffic()
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", 0)
    layers = bench_run.load_layers()
    train = traffic["kind"] == "train"
    if train:
        run = cells.TrainRun(cfg, traffic, args.seed, device)
        run.first_steps()
        units = traffic["trace_steps"]
    else:
        run = cells.ServeRun(cfg, traffic, args.seed, device)
        run.serve(inputs.schedule(traffic, run.seeds.schedule + 2, cells.WARMUP_S), keep_answers=False)
        units = traffic["trace_requests"]
    cells._sync(device)
    print(f"card: {bench_run.card_line() if device.type == 'cuda' else 'cpu'}; torch {torch.__version__}",
          file=sys.stderr, flush=True)

    def window(traced_layers, k):
        """One window of the cell's trace units; traced with ``traced_layers``
        (None: untraced). Returns (seconds a unit, record or None)."""
        if train:
            body = lambda: [run.step() for _ in range(units)]  # noqa: E731
        else:
            sub = inputs.schedule(traffic, run.seeds.schedule + 10 + k, traffic["trace_requests"] / traffic["rate_per_s"])
            holder = {}
            body = lambda: holder.update(served=run.serve(sub, keep_answers=False))  # noqa: E731
        p0 = nms_passes()
        if traced_layers is None:
            t0 = time.perf_counter()
            body()
            cells._sync(device)
            rec = {"window_s": time.perf_counter() - t0}
        else:
            with trace.traced(run.model, traced_layers, device) as rec:
                body()
        n = units if train else len(sub)
        rec["units"] = n
        if not train:
            s = holder["served"]
            rec["service_s"] = float(sum(s["end"] - s["start"]))
        p1 = nms_passes()
        rec["nms_passes"] = None if p0 is None else (p1 - p0) / n
        per_unit = (rec["window_s"] if train else rec["service_s"]) / n
        return per_unit, rec

    variants = [("spans+hooks", True, layers), ("stub+hooks", False, layers), ("spans", True, {}),
                ("stub", False, {}), ("untraced_spans", True, None), ("untraced_stub", False, None)]
    results = {name: [] for name, _, _ in variants}
    readings = []
    k = 0
    for turn in range(args.turns):
        order = variants if turn % 2 == 0 else variants[::-1]
        for name, spans_on, lay in order:
            set_spans(spans_on)
            per_unit, rec = window(lay, k)
            k += 1
            results[name].append(1e3 * per_unit)
            if lay is not None:
                results.setdefault(name + ".mvdetr_events", []).append(
                    sum(1 for e in _captured["events"] if str(e.get("name", "")).startswith("mvdetr:")))
            if name == "spans+hooks":
                r = span_readings(_captured["events"], rec)
                r["nms_passes"] = rec["nms_passes"]
                r["idle_gaps"] = rec["idle_gaps"]
                r["busy_s"], r["window_s"] = rec["busy_s"], rec["window_s"]
                readings.append(r)
                print(json.dumps({"turn": turn, **{a: b for a, b in r.items() if a != "idle_gaps"}}),
                      file=sys.stderr, flush=True)
            _captured.clear()
    set_spans(True)
    out = {"workload": args.workload, "seed": args.seed, "units": units, "ms_a_unit": results, "readings": readings,
           "unit": "step (window)" if train else "request (service)"}
    if train:
        run.close()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
