"""Shared helpers of the ``tests/test_torch_port_*.py`` files: the card
fixture, and seeded inputs that go through the JAX package and the port."""

import json

import numpy as np
import pytest
import torch

# training batches are built as chip_smoke.py builds them (the port's build_targets)
from chip_smoke import train_batch as synthetic_train_batch  # noqa: F401


@pytest.fixture
def cuda_device():
    """The card, or a skip. Decided inside the fixture, never at import, so
    every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py holds the kernel against its plain version on the card")
    return torch.device("cuda")


def windowed_inputs(rng, b, l, h, w, m, d, p, c, lo, hi):
    """value ``[B,L,H,W,M,D]``, offsets uniform in ``[lo, hi)`` and weights
    normalised over (L, P), all f32 numpy."""
    value = rng.standard_normal((b, l, h, w, m, d)).astype(np.float32)
    off = rng.uniform(lo, hi, (b, c, h, w, m, l, p, 2)).astype(np.float32)
    wgt = rng.uniform(0, 1, (b, c, h, w, m, l, p)).astype(np.float32)
    wgt /= wgt.sum(axis=(-1, -2), keepdims=True)
    return value, off, wgt


# B2's value side: (query rows, columns, levels or pseudo-levels, points) -> the value planes per block that its C
# entry picks, 4 where 4 planes' samples make up no more than the flagship's P = 4 (P = 1, L >= 4), else 1; at the
# shadow stack, the recipe's 32 pseudo-levels, the flagship and the recipe, ragged stacks and other P
VALUE_PLANES = {
    "shadow": ((60, 180, 56, 1), 4),
    "recipe-shadow": ((15, 30, 32, 1), 4),
    "flagship": ((60, 180, 7, 4), 1),
    "recipe": ((15, 30, 4, 4), 1),
    "ragged54": ((60, 180, 54, 1), 4),
    "ragged3": ((60, 180, 3, 1), 1),
    "ragged1": ((60, 180, 1, 1), 1),
    "points2": ((9, 21, 3, 2), 1),
    "points3": ((9, 21, 3, 3), 1),
}


@pytest.fixture(scope="module")
def few_torch_threads():
    """Two intra-op threads for the module's tests, the previous count after.
    The suite runs in several worker processes at once, and torch's default
    (one OpenMP thread per core in each process) oversubscribes the cores:
    a CPU epoch of a tiny model then takes minutes instead of seconds."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def spans_of(trace_path) -> dict:
    """``{name: [(tid, start, end)]}`` of a Chrome trace's ``mvdetr:*``
    annotations, by name without the prefix."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("mvdetr:"):
            out.setdefault(e["name"][len("mvdetr:"):], []).append((e["tid"], e["ts"], e["ts"] + e["dur"]))
    return out


def inside(inner, outers) -> bool:
    """Whether the span ``inner`` lies within one of ``outers`` on its thread."""
    tid, a, b = inner
    return any(t == tid and s <= a and b <= e for t, s, e in outers)
