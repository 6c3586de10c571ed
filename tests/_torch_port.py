"""Shared helpers of the ``tests/test_torch_port_*.py`` files: the card
fixture, and seeded inputs that go through the JAX package and the port."""

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
