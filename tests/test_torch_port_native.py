"""The port's native host library (``mvdetr_tpu_torch.native``) against its
references, on seeded inputs:

- the Gaussian splat against the numpy splat of ``data/targets.py``, within
  1e-6 (both round the same f64 Gaussian to f32);
- ``greedy_nms`` equal to the port's ``distance_nms`` (and so to the JAX
  package's, which ``test_torch_port_ops.py`` holds it to);
- the augmentation warp against ``cv2.warpPerspective(INTER_LINEAR)`` at q99
  of |diff| <= 2 levels (the bound of ``tests/test_native.py``), and equal
  to the JAX package's C++ warp but for a few pixels, where that build
  contracts products into FMAs and this one does not;
- the resize equal to ``cv2.resize(INTER_LINEAR)``, byte for byte;
- a missing compiler raises.
"""

import numpy as np
import pytest
import torch

from mvdetr_tpu import native as jax_native
from mvdetr_tpu_torch import native
from mvdetr_tpu_torch.data.targets import splat_gaussian as np_splat
from mvdetr_tpu_torch.ops import distance_nms


@pytest.mark.parametrize("sigma", [1.0, 2.5, 4.0])
def test_splat_matches_numpy(sigma):
    hm_native = np.zeros((40, 60), dtype=np.float32)
    hm_np = np.zeros((40, 60), dtype=np.float32)
    rng = np.random.default_rng(0)
    centers = np.concatenate([rng.integers(0, 60, (12, 1)), rng.integers(0, 40, (12, 1))], 1).astype(np.int32)
    centers = np.concatenate([centers, [[0, 0], [59, 39], [200, 200], [-30, 5]]]).astype(np.int32)
    native.splat_gaussian(hm_native, centers, sigma)
    for c in centers:
        np_splat(hm_np, c, sigma)
    np.testing.assert_allclose(hm_native, hm_np, atol=1e-6)
    assert hm_native.max() == 1.0


def test_splat_rejects_a_non_contiguous_heatmap():
    with pytest.raises(ValueError, match="C-contiguous"):
        native.splat_gaussian(np.zeros((8, 10), np.float32)[:, ::2], np.zeros((1, 2), np.int32), 1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_nms_equals_distance_nms(seed):
    r = np.random.default_rng(seed)
    pts = r.uniform(0, 40, (64, 2)).astype(np.float32)
    scores = r.uniform(0, 1, 64).astype(np.float32)
    scores[5] = scores[9]  # a tie: the earlier index goes first
    keep = native.greedy_nms(pts, scores, 6.0)
    ref = distance_nms(torch.from_numpy(pts), torch.from_numpy(scores), 6.0).numpy()
    np.testing.assert_array_equal(keep, ref)
    assert keep.dtype == bool and 0 < keep.sum() < 64


def _affines():
    return [np.array([[0.9, 0.05, 3.0], [-0.02, 1.1, -2.0], [1e-4, -1e-4, 1.0]]),  # perspective
            np.array([[-1.2, 0.0, 70.0], [0.0, 1.2, -5.0], [0.0, 0.0, 1.0]]),  # flip, scale, shift
            np.eye(3)]


@pytest.mark.parametrize("case", range(3))
def test_warp_matches_cv2(case):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(case)
    img = rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8)
    mat = _affines()[case]
    ours = native.warp_image_u8(img, mat, border=128)
    theirs = cv2.warpPerspective(img, mat, dsize=(64, 48), flags=cv2.INTER_LINEAR, borderValue=(128, 128, 128))
    diff = np.abs(ours.astype(int) - theirs.astype(int))
    assert np.quantile(diff, 0.99) <= 2, f"q99 diff {np.quantile(diff, 0.99)}"
    jax_ours = jax_native.warp_image_u8(img, mat, border=128)
    assert (np.abs(ours.astype(int) - jax_ours.astype(int)) > 1).sum() == 0
    assert (ours != jax_ours).mean() <= 1e-3
    if case == 2:
        np.testing.assert_array_equal(ours, img)


@pytest.mark.parametrize("shapes", [((96, 160), (64, 106)), ((180, 320), (120, 213)), ((37, 53), (80, 91)),
                                    ((1080, 1920), (720, 1280))])
def test_resize_equals_cv2(shapes):
    cv2 = pytest.importorskip("cv2")
    (h, w), (ho, wo) = shapes
    img = np.random.default_rng(h).integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_u8(img, (ho, wo)),
                                  cv2.resize(img, (wo, ho), interpolation=cv2.INTER_LINEAR))


def test_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'fatal: broken toolchain' >&2\nexit 1\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="broken toolchain"):
        native.build()
    assert not native.library_path().exists()
