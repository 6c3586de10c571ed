"""Shared helpers of the ``tests/test_torch_port_*.py`` files: the card
fixture, and seeded inputs that go through the JAX package and the port."""

import numpy as np
import pytest
import torch


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
