"""One run of a cell: set-up, the measured window, the traced sub-window
(``--trace 1``), and the comparison with the reference.

Training (``kind: train``): set-up builds one train state and one feed
(``prefetch_to_device`` over the cycled pool) and drives them through the
first ``warmup_steps`` steps, which build every kernel and which the
reference follows. The window then runs steps back to back on the same
state and feed for ``--seconds`` and ends with a synchronise.

Serving (``kind: serve``): set-up builds the model and serves the cell's
own traffic for ``WARMUP_S``. The window offers every request of the schedule at its due time
to one serving thread that answers them in order, each through
``eval_step`` and the copy of its detections to host memory; a request's
latency runs from its due time to that copy's end.
"""

from __future__ import annotations

import gc
import itertools
import sys
import time

import numpy as np
import torch

from benchmark.harness import check, inputs, system, trace

WINDOW_GRACE_S = 60.0  # a request due in the window may finish this long after it
WARMUP_S = 1.0  # serving's warm-up: the cell's own traffic for this long


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _settle(device):
    """End of set-up: everything queued done, and the set-up's objects out of
    the collector's scans (``gc.freeze``), so that a collection inside the
    window walks only what the window made."""
    _sync(device)
    gc.collect()
    gc.freeze()


def _free(device):
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def total_steps(cfg: dict, traffic: dict) -> int:
    return cfg["epochs"] * cfg["train_frames"] // traffic["batch_size"]


class TrainRun:
    """The program's side of a training cell, up to the window's end."""

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.rig = inputs.rig_of(cfg)
        self.seeds = inputs.Seeds(seed)
        self.weights = inputs.make_weights(cfg, self.rig, self.seeds.weights, device)
        self.pool = inputs.train_pool(cfg, traffic, self.rig, self.seeds, device)
        self.model = system.build_model(cfg, self.rig, self.weights, device)
        self.state = system.create_train_state(self.model, cfg, total_steps(cfg, traffic))
        self.generator = torch.Generator(device=device).manual_seed(self.seeds.dropout)
        self.feed = system.prefetch_to_device(itertools.cycle(self.pool), device, traffic["prefetch"])

    def step(self):
        self.state, aux = system.train_step(self.state, next(self.feed), self.generator, self.device)
        return aux

    def first_steps(self) -> dict:
        """The first steps, with what the comparison reads of them."""
        losses, moments = [], None
        for i in range(self.traffic["warmup_steps"]):
            losses.append(self.step()["loss"])
            if i == 0:
                moments = check.moment_norms(self.state.optimizer, self.model.named_parameters())
        delta = check.delta_norms(self.model.named_parameters(), self.weights)
        return {"loss": losses, "moment": moments, "delta": delta}

    def window(self, seconds: float) -> dict:
        losses, dispatch = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            losses.append(self.step()["loss"])
            dispatch.append(time.perf_counter() - t)
        _sync(self.device)
        elapsed = time.perf_counter() - t0
        return {"steps": len(losses), "seconds": elapsed, "losses": torch.stack(losses), "dispatch_s": dispatch}

    def close(self):
        self.feed.close()


def run_train(cfg, traffic, seed, seconds, trace_on, device, t_start, layers, limits) -> dict:
    run = TrainRun(cfg, traffic, seed, device)
    first = run.first_steps()
    _settle(device)
    setup_s = time.perf_counter() - t_start
    launches0 = system.kernel_launches()
    win = run.window(seconds)
    launches = {k: (v - launches0[k]) / win["steps"] for k, v in system.kernel_launches().items()}
    b = traffic["batch_size"]
    out = {"attempted": win["steps"], "failed": int((~torch.isfinite(win["losses"])).sum()),
           "metrics": {"train_framesets_per_s": win["steps"] * b / win["seconds"], "setup_s": setup_s},
           "launches_per_step": launches}
    if trace_on:
        with trace.traced(run.model, layers, device) as rec:
            for _ in range(traffic["trace_steps"]):
                run.step()
        rec.update(units=traffic["trace_steps"], dispatch_s=win["dispatch_s"], batch=b)
        out["record"] = rec
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog = check.to_host(first)
    run.close()
    weights, pool, rig, seeds = run.weights, run.pool, run.rig, run.seeds
    del run
    _free(device)
    ref = check.reference_train(cfg, rig, weights, pool[:traffic["warmup_steps"]], seeds.dropout,
                                total_steps(cfg, traffic), device)
    out["numbers"] = check.train_numbers(prog, ref)
    out["correct"], out["checks"] = check.judge(out["numbers"], limits)
    return out


class ServeRun:
    """The program's side of a serving cell."""

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.rig = inputs.rig_of(cfg)
        self.seeds = inputs.Seeds(seed)
        self.weights = inputs.make_weights(cfg, self.rig, self.seeds.weights, device)
        calibration = inputs.random_frames(cfg, 1, self.seeds.data, device, pin=False)
        inputs.calibrate_running_stats(cfg, self.rig, self.weights, calibration, device)
        self.pool = inputs.serve_pool(cfg, traffic, self.seeds, device)
        self.model = system.build_model(cfg, self.rig, self.weights, device)
        self.answers = []

    def request(self, idx: int):
        _, xys, keep = system.eval_step(self.model, self.pool[idx], self.cfg, self.device)
        return xys[0].cpu().numpy(), keep[0].cpu().numpy()

    def serve(self, plan: list, keep_answers: bool) -> dict:
        """Offer ``plan`` (``(due, rig, pool index)``) from now on; returns
        each request's due, start and end times (seconds from the start)."""
        due, start, end = [], [], []
        t0 = time.perf_counter()
        for d, _, idx in plan:
            now = time.perf_counter() - t0
            if now < d:
                time.sleep(d - now)
            s = time.perf_counter() - t0
            xys, keep = self.request(idx)
            due.append(d)
            start.append(s)
            end.append(time.perf_counter() - t0)
            if keep_answers:
                self.answers.append((idx, xys, keep))
        return {"due": np.array(due), "start": np.array(start), "end": np.array(end)}


def run_serve(cfg, traffic, seed, seconds, trace_on, device, t_start, layers, limits) -> dict:
    run = ServeRun(cfg, traffic, seed, device)
    run.serve(inputs.schedule(traffic, run.seeds.schedule + 2, WARMUP_S), keep_answers=False)
    _settle(device)
    setup_s = time.perf_counter() - t_start
    plan = inputs.schedule(traffic, run.seeds.schedule, seconds)
    launches0 = system.kernel_launches()
    served = run.serve(plan, keep_answers=True)
    launches = {k: (v - launches0[k]) / len(plan) for k, v in system.kernel_launches().items()}
    latency_ms = (served["end"] - served["due"]) * 1e3
    print(f"serve: service median {np.median(served['end'] - served['start']) * 1e3:.3f} ms, queue median "
          f"{np.median(served['start'] - served['due']) * 1e3:.3f} ms, {len(plan)} requests", file=sys.stderr)
    late = served["end"] - seconds > WINDOW_GRACE_S
    out = {"attempted": len(plan), "failed": int(late.sum()),
           "metrics": {"serve_p95_ms": float(np.percentile(latency_ms, 95)),
                       "serve_p50_ms": float(np.percentile(latency_ms, 50)), "setup_s": setup_s},
           "launches_per_request": launches}
    if trace_on:
        sub = inputs.schedule(traffic, run.seeds.schedule + 1, traffic["trace_requests"] / traffic["rate_per_s"])
        with trace.traced(run.model, layers, device) as rec:
            traced = run.serve(sub, keep_answers=False)
        rec.update(units=len(sub), service_s=float(np.sum(traced["end"] - traced["start"])),
                   queue_s=list(served["start"] - served["due"]), batch=1)
        out["record"] = rec
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    answers, weights, pool, rig = run.answers, run.weights, run.pool, run.rig
    del run
    _free(device)
    refs = check.reference_answers(cfg, rig, weights, pool, device)
    out["numbers"] = check.serve_numbers(answers, refs, cfg)
    out["correct"], out["checks"] = check.judge(out["numbers"], limits)
    return out
