"""The traced sub-window: spans from the benchmark's own hooks, a
``torch.profiler`` trace, and its reduction to a plain record that the
per-layer metric readers (``benchmark/metrics/*.py``) read.

Spans. Each layer file (``benchmark/layers/<layer>.json``) names what
belongs to the layer:

- ``modules``: module paths in the model (``"base"``), and ``module_types``:
  class names of module instances (``"BatchNorm2d"``). A forward pre-hook
  and a forward hook open and close a ``bench:<layer>`` annotation around
  each instance's forward. Kernels launched inside it are the layer's
  forward. A backward node belongs to the layer when autograd's sequence
  number, which its ``evaluate_function`` event carries, lies within the
  numbers that the ops inside one of the layer's forward spans recorded
  (numbers grow along the forward thread, so a span's nodes lie in the
  range of its first and last op).
- ``functions``: ``module:function`` names in the program, wrapped for the
  traced window only in a ``bench:<layer>`` annotation; ``"sync": true``
  synchronises before the call, so that its host time is its own.
- ``kernels``: parts of device kernel names (B3's ``warp_bwd``), with the
  memsets that the same host op issues between such launches.

A kernel is tied to its host op through the CUDA runtime call that launched
it (the ``correlation`` id) and the host ops that enclose that call in time.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
EVALUATE = "autograd::engine::evaluate_function"
WINDOW = "bench:window"


def _enter(name: str):
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class Spans:
    """Install the layers' hooks on ``model`` and wrap their functions;
    ``close()`` removes them all."""

    def __init__(self, model: torch.nn.Module, layers: dict):
        self.handles, self.patched = [], []
        open_spans = defaultdict(list)
        for name, spec in layers.items():
            paths, types = set(spec.get("modules", ())), set(spec.get("module_types", ()))
            for path, module in model.named_modules():
                if path in paths or type(module).__name__ in types:
                    key = (name, id(module))

                    def pre(_m, _args, key=key, label=f"bench:{name}"):
                        open_spans[key].append(_enter(label))

                    def post(_m, _args, _out, key=key):
                        open_spans[key].pop().__exit__(None, None, None)

                    self.handles.append(module.register_forward_pre_hook(pre))
                    self.handles.append(module.register_forward_hook(post))
            for target in spec.get("functions", ()):
                self._wrap(target, f"bench:{name}", bool(spec.get("sync")))

    def _wrap(self, target: str, label: str, sync: bool):
        module_name, fn_name = target.split(":")
        module = importlib.import_module(module_name)
        inner = getattr(module, fn_name)

        def wrapped(*args, **kwargs):
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            with torch.profiler.record_function(label):
                return inner(*args, **kwargs)

        setattr(module, fn_name, wrapped)
        self.patched.append((module, fn_name, inner))

    def close(self):
        for h in self.handles:
            h.remove()
        for module, fn_name, inner in self.patched:
            setattr(module, fn_name, inner)


@contextlib.contextmanager
def traced(model, layers: dict, device):
    """Profile the block with the layers' spans on; yields a dict that holds
    the reduced record (:func:`reduce_trace`) once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    spans = Spans(model, layers)
    out = {}
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(WINDOW):
                yield out
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            out["window_s"] = time.perf_counter() - t0
    finally:
        spans.close()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out.update(reduce_trace(events, layers))


def _ancestors(host: list, points: list) -> list:
    """For each point ``(tid, ts)``, the indices into ``host`` (events of
    that tid) that enclose it, outermost first."""
    def end(i):
        return host[i]["ts"] + host[i].get("dur", 0)

    by_tid = defaultdict(list)
    for i, e in enumerate(host):
        by_tid[e["tid"]].append(i)
    asks = defaultdict(list)
    for k, (tid, ts) in enumerate(points):
        asks[tid].append((ts, k))
    out = [[] for _ in points]
    for tid, queries in asks.items():
        idx = sorted(by_tid.get(tid, []), key=lambda i: (host[i]["ts"], -host[i].get("dur", 0)))
        stack, n = [], 0
        for ts, k in sorted(queries):
            while n < len(idx) and host[idx[n]]["ts"] <= ts:
                while stack and end(stack[-1]) < host[idx[n]]["ts"]:
                    stack.pop()
                stack.append(idx[n])
                n += 1
            out[k] = [i for i in stack if end(i) >= ts]
    return out


def reduce_trace(events: list, layers: dict) -> dict:
    """A chrome trace's events -> ``{"window": (t0, t1) us, "device": [(name,
    ts, dur, cat)], "layer_events": {layer: [device event indices]},
    "host_spans": {layer: [host us]}, "busy_s", "idle_gaps": [(host op,
    seconds)], "device_ops": [(name, seconds)]}``."""
    xs = [e for e in events if e.get("ph") == "X"]
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    runtime = [e for e in xs if e.get("cat") in RUNTIME_CATS]
    windows = [e for e in host if e["name"] == WINDOW]
    if not windows:
        raise RuntimeError("trace: no bench:window annotation")
    win = windows[0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    main_tid = win["tid"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1]

    corr_launch = {e["args"]["correlation"]: j for j, e in enumerate(runtime) if "correlation" in e.get("args", {})}
    anc = _ancestors(host, [(e["tid"], e["ts"]) for e in runtime])

    # the forward ranges of sequence numbers of each layer's spans
    ranges = defaultdict(list)
    seq_ops = [(e["ts"], e["args"]["Sequence number"]) for e in host
               if e["tid"] == main_tid and "Sequence number" in e.get("args", {}) and not e["name"].startswith(EVALUATE)]
    seq_ops.sort()
    seq_ts = [t for t, _ in seq_ops]
    host_spans = defaultdict(list)
    for e in host:
        if e["name"].startswith("bench:") and e["name"] != WINDOW:
            layer = e["name"][6:]
            host_spans[layer].append(e["dur"])
            lo, hi = bisect.bisect_left(seq_ts, e["ts"]), bisect.bisect_right(seq_ts, e["ts"] + e["dur"])
            seqs = [s for _, s in seq_ops[lo:hi]]
            if seqs:
                ranges[layer].append((min(seqs), max(seqs)))

    layer_events = defaultdict(list)
    kernel_parts = {name: spec["kernels"] for name, spec in layers.items() if spec.get("kernels")}
    launches_by_op = defaultdict(list)  # (layer, innermost host op) -> runtime ts of its matching launches
    for k, e in enumerate(device):
        j = corr_launch.get(e.get("args", {}).get("correlation"))
        chain = anc[j] if j is not None else []
        member = set()
        for i in chain:
            h = host[i]
            if h["name"].startswith("bench:") and h["name"] != WINDOW:
                member.add(h["name"][6:])
            elif h["name"].startswith(EVALUATE) and "Sequence number" in h.get("args", {}):
                s = h["args"]["Sequence number"]
                member.update(layer for layer, rs in ranges.items() if any(lo <= s <= hi for lo, hi in rs))
        for layer, parts in kernel_parts.items():
            if e.get("cat") == "kernel" and any(p in e["name"] for p in parts):
                member.add(layer)
                if j is not None and chain:
                    launches_by_op[(layer, chain[-1])].append(runtime[j]["ts"])
        for layer in member:
            layer_events[layer].append(k)
    for k, e in enumerate(device):  # the memsets a kernel layer's host op issues between its launches
        j = corr_launch.get(e.get("args", {}).get("correlation"))
        if e.get("cat") != "gpu_memset" or j is None or not anc[j]:
            continue
        for (layer, op), ts in launches_by_op.items():
            if op == anc[j][-1] and min(ts) <= runtime[j]["ts"] <= max(ts) and k not in layer_events[layer]:
                layer_events[layer].append(k)

    segments = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy_us = sum(b - a for a, b in segments)
    gaps, last = [], w0
    for a, b in segments + [(w1, w1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    main_host = [e for e in host + runtime if e["tid"] == main_tid and e["name"] != WINDOW]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    mids = _ancestors(main_host, [(main_tid, (a + b) / 2) for a, b in longest])
    idle = [(main_host[m[-1]]["name"] if m else "(no host op)", (b - a) / 1e6) for (a, b), m in zip(longest, mids)]
    by_name = defaultdict(float)
    for e in device:
        by_name[e["name"]] += e["dur"] / 1e6
    return {"window_us": (w0, w1), "device": [(e["name"], e["ts"], e["dur"], e.get("cat")) for e in device],
            "layer_events": dict(layer_events), "host_spans": dict(host_spans), "busy_s": busy_us / 1e6,
            "idle_gaps": idle, "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10]}


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(s) for s in out]


def layer_seconds(rec: dict, layer: str, minus: tuple = (), cat: str | None = None, name_part: str | None = None) -> float:
    """Device seconds of the events of ``layer`` in a reduced record that
    belong to none of the layers ``minus``, optionally of one category
    (``gpu_memcpy``) and with ``name_part`` in their name."""
    own = set(rec["layer_events"].get(layer, ()))
    for other in minus:
        own -= set(rec["layer_events"].get(other, ()))
    total = 0.0
    for k in own:
        name, _, dur, c = rec["device"][k]
        if (cat is None or c == cat) and (name_part is None or name_part in name):
            total += dur
    return total / 1e6
