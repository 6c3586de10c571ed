"""Backward of the perspective warp (TPU kernel B3): the port's plain
``bilinear_scatter_matmul`` against the JAX function of that name and the
Pallas kernel ``warp_bwd_pallas`` in interpret mode, and the warp's autograd
Function against autograd of the plain gather. The CUDA kernel is held
against the plain version on the card by ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py``.

Tolerances: in f32 the two sides sum the same products in another order ->
atol 1e-5 on cotangents of order 1-10. In bf16 both round ``R`` and
``R (x) g`` to bf16 at the same places and the final sum once; a sum that
lands next to a bf16 rounding boundary may round one step apart (a step is
2^-8 to 2^-7 of the value) -> rtol 2^-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import WARP_STRESS_NAMES, warp_stress_cases
from mvdetr_tpu.ops.pallas.warp_bwd import warp_bwd_pallas
from mvdetr_tpu.ops.sampling import bilinear_scatter_matmul as jax_scatter
from mvdetr_tpu_torch.ops.sampling import bilinear_patch_sample, bilinear_scatter_matmul
from mvdetr_tpu_torch.ops.warp import (
    alloc_scratch,
    check_sizes,
    perspective_warp,
    sort_end_bit,
    warp_bwd,
    warp_coords,
    warp_scatter_accumulate,
)

BF16_RTOL = 2.0**-6


def _coords(rng, b, q, h, w):
    """Source coordinates of a tilted homography over a small BEV grid, plus
    a share of points past every edge and exact integers."""
    sx = rng.uniform(-3.0, w + 2.0, (b, q)).astype(np.float32)
    sy = rng.uniform(-3.0, h + 2.0, (b, q)).astype(np.float32)
    sx[:, ::7] = np.floor(sx[:, ::7])
    sy[:, 1::9] = np.floor(sy[:, 1::9])
    return sx, sy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_bilinear_scatter_matmul(dtype, rng):
    """Q = 1000 with chunk 256: the last chunk is padded with far-out
    coordinates on both sides."""
    b, q, c, h, w = 2, 1000, 24, 9, 13
    sx, sy = _coords(rng, b, q, h, w)
    g = rng.standard_normal((b, q, c)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    ref = np.asarray(jax_scatter(jnp.asarray(g).astype(jd), jnp.asarray(sx), jnp.asarray(sy), h, w, chunk=256)
                     .astype(jnp.float32))
    ours = bilinear_scatter_matmul(torch.from_numpy(g).to(td), torch.from_numpy(sx), torch.from_numpy(sy), h, w,
                                   chunk=256)
    assert ours.dtype == td and ours.shape == (b, h, w, c)
    if dtype == "bfloat16":
        np.testing.assert_allclose(ours.float().numpy(), ref, rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_plain_matches_warp_bwd_pallas(rng):
    """The Pallas kernel in interpret mode with an f32 contraction (its
    production bf16 rounds R (x) g in f32 first, the XLA path in bf16); W=16
    and C=128 meet its tiling, and Q = 300 is padded to its 128-query chunks."""
    b, q, c, h, w = 2, 300, 128, 10, 16
    sx, sy = _coords(rng, b, q, h, w)
    g = rng.standard_normal((b, q, c)).astype(np.float32)
    ref = np.asarray(warp_bwd_pallas(jnp.asarray(g), jnp.asarray(sx), jnp.asarray(sy), h, w,
                                     kernel_dtype=jnp.float32, interpret=True))
    ours = bilinear_scatter_matmul(torch.from_numpy(g), torch.from_numpy(sx), torch.from_numpy(sy), h, w)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_warp_function_gradient_matches_autograd_of_the_gather(rng):
    """perspective_warp's backward (the plain scatter-matmul on the CPU)
    against autograd of the plain gather, in f32, through a homography with
    perspective that maps part of the grid outside the source; the
    homography gets no gradient."""
    feats = torch.from_numpy(rng.standard_normal((3, 9, 14, 6)).astype(np.float32))
    mats = torch.tensor([[1.3, 0.2, -2.0], [-0.1, 1.1, 1.5], [0.004, -0.003, 1.0]]).repeat(3, 1, 1)
    mats[1, 0, 2] += 3.5
    mats.requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 12, 17, 6)).astype(np.float32))
    f1 = feats.clone().requires_grad_()
    perspective_warp(f1, mats, (12, 17)).backward(g)
    f2 = feats.clone().requires_grad_()
    sx, sy = warp_coords(mats.detach(), (12, 17))
    bilinear_patch_sample(f2, sx, sy).reshape(g.shape).backward(g)
    torch.testing.assert_close(f1.grad, f2.grad, rtol=0, atol=1e-5)
    assert mats.grad is None
    assert float(f1.grad.abs().sum()) > 0


def test_dispatch_on_cpu_and_kernel_wrapper_refuses_cpu_tensors(rng):
    """A CPU tensor runs the plain version; the B3 wrapper takes CUDA
    tensors or raises, and counts nothing then."""
    sx, sy = (torch.from_numpy(a) for a in _coords(rng, 1, 50, 5, 7))
    g = torch.from_numpy(rng.standard_normal((1, 50, 4)).astype(np.float32))
    torch.testing.assert_close(warp_scatter_accumulate(g, sx, sy, 5, 7), bilinear_scatter_matmul(g, sx, sy, 5, 7),
                               rtol=0, atol=0)
    before = warp_bwd.launches
    with pytest.raises(ValueError, match="CUDA device only"):
        warp_bwd(g, sx, sy, 5, 7)
    assert warp_bwd.launches == before


@pytest.mark.parametrize("h,w,bits", [(1, 1, 3), (1, 2, 3), (2, 2, 4), (31, 31, 11), (31, 32, 11), (30, 32, 10),
                                       (90, 160, 14), (60, 180, 14), (120, 360, 16), (2**15, 2**15, 31)])
def test_sort_end_bit_covers_the_sentinel(h, w, bits):
    """B3 sorts one key a sample, its base cell on the per-map (h+1) x (w+1)
    grid, ``0 .. (h+1)*(w+1) - 1``, the last key the sentinel of a sample
    whose taps all fall outside, over the fewest bits that hold them: 14 at
    the flagship (90 x 160) and gather mode (60 x 180), 16 at aio's and
    deform_conv's 120 x 360; at a 32 x 32 grid the sentinel 1024 takes the
    top bit of 11."""
    sentinel = (h + 1) * (w + 1)
    assert sort_end_bit(h, w) == bits
    assert sentinel >> bits == 0 and sentinel >> (bits - 1) == 1


def test_check_sizes_refuses_what_overflows_the_kernels_int32_indices():
    """Samples B*Q, cells B*h*w and bins B*(h+1)*(w+1) in int32; h and w
    exact in f32."""
    check_sizes(14, 43200, 90, 160)  # the flagship
    check_sizes(112, 302400, 60, 180)  # gather mode
    check_sizes(1, 2**31 - 2, 1, 1)
    with pytest.raises(ValueError, match="2\\^31"):
        check_sizes(1, 2**31 - 1, 1, 1)  # B*Q samples
    with pytest.raises(ValueError, match="2\\^31"):
        check_sizes(2, 1, 2**15, 2**15)  # B*h*w cells
    with pytest.raises(ValueError, match="2\\^31"):
        check_sizes(1, 1, 46340, 46340)  # B*h*w = 2147395600 fits, B*(h+1)*(w+1) does not
    with pytest.raises(ValueError, match="2\\^24"):
        check_sizes(1, 1, 1, 2**24)


class _FakeSortLibrary:
    """Stands in for the built library's ``warp_bwd_temp_bytes``: records
    what the sort is sized for and answers a fixed byte count."""

    def __init__(self):
        self.asked = []

    def warp_bwd_temp_bytes(self, n, end_bit, nbytes):
        self.asked.append((n, end_bit))
        nbytes._obj.value = 4096 + n
        return 0


@pytest.mark.parametrize("b,q,h,w,bits", [(112, 302400, 60, 180, 14), (14, 43200, 90, 160, 14),
                                          (14, 388800, 120, 360, 16), (3, 1500, 7, 9, 7)])
def test_alloc_scratch_sizes_one_key_a_sample(b, q, h, w, bits):
    """B3's scratch at gather's, the flagship's, deform_conv's and the edges
    stress case's shapes (on the meta device: nothing is allocated): keys
    and indices for B*Q samples, not 4*B*Q entries, each sample's (wx1, wy1),
    a start per (base cell, map) bin and one more, and the sort sized for B*Q
    keys of ``sort_end_bit(h, w)`` bits."""
    lib = _FakeSortLibrary()
    s = alloc_scratch(lib, b, q, h, w, "meta")
    n = b * q
    assert s.keys.shape == (2, n) and s.order.shape == (2, n) and s.rec.shape == (2, n, 2)
    assert s.keys.dtype == s.order.dtype == s.start.dtype == torch.int32 and s.rec.dtype == torch.float32
    assert s.start.shape == (b * (h + 1) * (w + 1) + 1,)
    assert s.end_bit == bits == sort_end_bit(h, w) and lib.asked == [(n, bits)] and s.temp.numel() == 4096 + n


@pytest.mark.parametrize("name", WARP_STRESS_NAMES)
def test_plain_matches_jax_at_the_b3_stress_cases(name):
    """The cases the card holds B3 to (``chip_smoke.warp_stress_cases``),
    through the port's plain version and the JAX function on the CPU: one
    cell of 3000 entries per tap (exact: bitwise equal), segments of 1-97
    entries, every tap outside (zeros), NaN / +-1e6 coordinates (NaN taken
    as a far-out coordinate, as the kernel takes it), C = 5, 40 in f32 and
    300 in bf16, B*H*W = 1024, a g that starts 2 bytes into its storage;
    gather mode's shape in small (C = 16, ~130 entries a cell over 4 maps,
    exact), bases on the grid's edges across maps (exact), C = 8, and C = 16
    two bytes into its storage. Tolerances as in the tests above."""
    case = warp_stress_cases(np.random.default_rng(0), device="cpu")[name]
    g, h, w = case["g"], case["h"], case["w"]
    sx, sy = case["ref_xy"] or (case["sx"], case["sy"])
    ours = bilinear_scatter_matmul(g, sx, sy, h, w)
    jd = jnp.bfloat16 if g.dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jax_scatter(jnp.asarray(g.float().numpy()).astype(jd), jnp.asarray(sx.numpy()),
                                 jnp.asarray(sy.numpy()), h, w).astype(jnp.float32))
    assert ours.shape == (g.shape[0], h, w, g.shape[2]) and torch.isfinite(ours).all()
    if case["exact"]:
        np.testing.assert_array_equal(ours.float().numpy(), ref)
    elif g.dtype == torch.bfloat16:
        np.testing.assert_allclose(ours.float().numpy(), ref, rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    if name == "all-outside":
        assert not ours.any()
