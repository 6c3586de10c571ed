"""View-coherent data augmentation (host-side), port of
``mvdetr_tpu/data/augment.py``.

Contract from the original MVDeTr's ``utils/image_utils.py:9-83``
(``random_affine``): per-view random affine M = Shear @ Translate @ Rotate/Scale
@ Flip applied to the full-resolution image (gray border fill), bboxes warped
through M with degenerate-box filtering, and **M itself returned** so the
model can fuse inv(M) into the BEV projection (`models/mvdetr.py:155-161`).

Defaults (`image_utils.py:9`): hflip p=0.5, translate ±20%, scale 0.6–1.4,
rotation/shear disabled.

:func:`random_affine_matrix` and :func:`warp_bboxes` are copied unchanged, so
the same numpy generator draws the same M. The image warp is bilinear on every
machine, through :func:`mvdetr_tpu_torch.native.warp_image_u8` (what the JAX
package gets from ``cv2.warpPerspective(INTER_LINEAR)``; its fallback without
cv2 is nearest-neighbour, which the port does not copy).
"""

from __future__ import annotations

import math

import numpy as np

from mvdetr_tpu_torch import native


def random_affine_matrix(
    img_shape,
    rng: np.random.Generator,
    hflip: float = 0.5,
    degrees=(0.0, 0.0),
    translate=(0.2, 0.2),
    scale=(0.6, 1.4),
    shear=(0.0, 0.0),
):
    """Draw M = S @ T @ R @ F in full-resolution pixel coords (`image_utils.py:19-42`)."""
    height, width = img_shape
    F = np.eye(3)
    if rng.random() < hflip:
        F[0, 0] = -1
        F[0, 2] = width

    angle = rng.random() * (degrees[1] - degrees[0]) + degrees[0]
    s = rng.random() * (scale[1] - scale[0]) + scale[0]
    R = np.eye(3)
    a = math.radians(angle)
    ca, sa = math.cos(a) * s, math.sin(a) * s
    cx, cy = width / 2.0, height / 2.0
    R[:2] = np.array([[ca, sa, cx - ca * cx - sa * cy], [-sa, ca, cy + sa * cx - ca * cy]])

    T = np.eye(3)
    T[0, 2] = (rng.random() * 2 - 1) * translate[0] * width
    T[1, 2] = (rng.random() * 2 - 1) * translate[1] * height

    Sh = np.eye(3)
    Sh[0, 1] = math.tan((rng.random() * (shear[1] - shear[0]) + shear[0]) * math.pi / 180)
    Sh[1, 0] = math.tan((rng.random() * (shear[1] - shear[0]) + shear[0]) * math.pi / 180)

    return Sh @ T @ R @ F, angle


def warp_bboxes(bboxes: np.ndarray, M: np.ndarray, img_shape, angle_deg: float = 0.0):
    """Warp x1y1x2y2 boxes through M with the reference's corner-hull +
    angle-reduction + degeneracy filter (`image_utils.py:46-81`).

    Returns (bboxes, keep_index)."""
    height, width = img_shape
    n = bboxes.shape[0]
    if n == 0:
        return bboxes.reshape(0, 4), np.zeros(0, dtype=bool)
    area0 = (bboxes[:, 2] - bboxes[:, 0]) * (bboxes[:, 3] - bboxes[:, 1])

    xy = np.ones((n * 4, 3))
    xy[:, :2] = bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    xy = (xy @ M.T)[:, :2].reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)

    radians = angle_deg * math.pi / 180
    reduction = max(abs(math.sin(radians)), abs(math.cos(radians))) ** 0.5
    cx_, cy_ = (new[:, 2] + new[:, 0]) / 2, (new[:, 3] + new[:, 1]) / 2
    w_ = (new[:, 2] - new[:, 0]) * reduction
    h_ = (new[:, 3] - new[:, 1]) * reduction
    new = np.stack([cx_ - w_ / 2, cy_ - h_ / 2, cx_ + w_ / 2, cy_ + h_ / 2], axis=1)

    new[:, [0, 2]] = np.clip(new[:, [0, 2]], 0, width - 1)
    new[:, [1, 3]] = np.clip(new[:, [1, 3]], 0, height - 1)
    w_ = new[:, 2] - new[:, 0]
    h_ = new[:, 3] - new[:, 1]
    area = w_ * h_
    ar = np.maximum(w_ / (h_ + 1e-16), h_ / (w_ + 1e-16))
    keep = (w_ > 4) & (h_ > 4) & (area / (area0 + 1e-16) > 0.1) & (ar < 10)
    return new[keep], keep


def random_affine(img: np.ndarray, bboxes: np.ndarray, pids: np.ndarray, rng: np.random.Generator, **kw):
    """Full augmentation: warped image (gray border), filtered boxes/pids, and M."""
    M, angle = random_affine_matrix(img.shape[:2], rng, **kw)
    height, width = img.shape[:2]
    warped = native.warp_image_u8(img, M, border=128)
    new_boxes, keep = warp_bboxes(np.asarray(bboxes, dtype=np.float64).reshape(-1, 4), M, (height, width), angle)
    return warped, new_boxes, np.asarray(pids)[keep], M
