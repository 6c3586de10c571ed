"""Tests that need the card. They import nothing of JAX, so the card's machine
runs them as they are (``python -m pytest tests/test_torch_port_cuda.py -q``);
elsewhere every test skips. ``chip_smoke.py`` repeats the kernel check at the
flagship shape."""

import numpy as np
import pytest
import torch

from mvdetr_tpu_torch.geometry import make_synthetic_rig
from mvdetr_tpu_torch.models import MVDeTr
from mvdetr_tpu_torch.ops.msda_windowed import ms_deform_attn_windowed, msda_windowed_fwd, windowed_attention
from mvdetr_tpu_torch.train import eval_step
from _torch_port import cuda_device, windowed_inputs  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("radius,m,d", [(4, 8, 16), (1, 2, 16), (8, 2, 16), (2, 3, 5)])
def test_kernel_matches_plain_on_card(radius, m, d, rng, cuda_device):
    """CUDA kernel vs the plain version fed the same bf16 value: only the f32
    summation order differs, outputs of order 1 -> atol 2e-5."""
    value, off, wgt = windowed_inputs(rng, 2, 3, 9, 21, m, d, 4, 3, -radius - 1.5, radius + 1.5)
    v = torch.from_numpy(value).to(cuda_device, torch.bfloat16)
    o = torch.from_numpy(off).to(cuda_device)
    w = torch.from_numpy(wgt).to(cuda_device)
    before = msda_windowed_fwd.launches
    out = windowed_attention(v, o, w, radius=radius, flatten=False)
    torch.cuda.synchronize()
    assert msda_windowed_fwd.launches == before + 1
    ref = ms_deform_attn_windowed(v, o, w, radius, flatten=False)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)


def test_kernel_refuses_gradients(rng, cuda_device):
    value, off, wgt = windowed_inputs(rng, 1, 2, 4, 6, 8, 16, 2, 2, -2.0, 2.0)
    v = torch.from_numpy(value).to(cuda_device).requires_grad_()
    out = windowed_attention(v, torch.from_numpy(off).to(cuda_device), torch.from_numpy(wgt).to(cuda_device), 2)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


def test_eval_step_on_card_launches_the_kernel_per_layer(cuda_device):
    rig = make_synthetic_rig(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96))
    model = MVDeTr.from_rig(rig, world_reduce=2, img_reduce=12, compute_dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    batch = {"imgs": rng.integers(0, 256, (2, 3, 64, 106, 3), dtype=np.uint8),
             "affine_mats": np.tile(np.eye(3, dtype=np.float32), (2, 3, 1, 1))}
    before = msda_windowed_fwd.launches
    aux, xys, keep = eval_step(model, batch, world_reduce=2, num_candidates=64)
    assert msda_windowed_fwd.launches == before + 3
    assert xys.shape == (2, 64, 3) and keep.shape == (2, 64)
    assert torch.isfinite(xys).all() and 0.0 <= float(aux["offset_clip_fraction"]) <= 1.0
