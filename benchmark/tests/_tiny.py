"""Tiny cells for the CPU tests: the configurations' files at 2 cameras, a
96x160 input and a 16x32 BEV grid, in f32 unless a test asks for bf16; the
traffic mixes at a few batches and requests."""

import json
import os

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("windowed", "gather")


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def config(mode: str, dtype: str = "float32") -> dict:
    cfg = load("configs", f"wildtrack_{mode}.json")
    cfg.update(num_cam=2, img_shape=[144, 240], worldgrid_shape=[64, 128], compute_dtype=dtype)
    return cfg


def train_traffic() -> dict:
    traffic = load("traffic", "train.json")
    traffic.update(pool_batches=3, trace_steps=1)
    return traffic


def serve_traffic() -> dict:
    return {"kind": "serve", "frames_per_request": 1, "rigs": 2, "rate_per_s": 4.0, "phases": [0.0, 0.5],
            "jitter_ms": 2.0, "pool_frames": 2, "host_memory": "pageable", "trace_requests": 2}


def limits(mode: str, kind: str) -> dict:
    return load("limits", f"wildtrack_{mode}.json")[kind]


CPU = torch.device("cpu")
