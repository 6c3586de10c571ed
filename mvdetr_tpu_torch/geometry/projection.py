"""Planar projective geometry for calibrated multi-camera rigs.

Numerical contract follows the reference implementation
(`multiview_detector/utils/projection.py:4-43`): a camera with
intrinsics ``K`` (3x3) and extrinsics ``E = [R|t]`` (3x4) maps a world point on
the horizontal plane at height ``z`` to image pixels through the 3x3 homography

    P(z) = K @ E @ [[1,0,0], [0,1,0], [0,0,z], [0,0,1]]

All matrices here are plain numpy and are computed once at rig-construction
time; the results are baked into jitted programs as constants.

Coordinate conventions (shared by the whole framework):
- image coordinates are (x, y) = (column, row) in pixels,
- world coordinates are (x, y) on the ground plane in the dataset's native
  unit (meters or centimeters — see ``CameraRig.worldcoord_unit``),
- homogeneous points are column-style ``[x, y, 1]`` but the public API takes
  and returns arrays of shape ``[..., 2]``.

Copied unchanged (imports aside) from ``mvdetr_tpu/geometry/projection.py``; the port keeps its own
copy so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


def plane_homography(intrinsic: np.ndarray, extrinsic: np.ndarray, z: float = 0.0) -> np.ndarray:
    """3x3 homography: world plane at height ``z`` -> image pixels.

    Mirrors `projection.py:27-34` (``get_imgcoord_from_worldcoord_mat``).
    ``z`` is expressed in world-coordinate units.
    """
    drop_z = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, z], [0.0, 0.0, 1.0]])
    return np.asarray(intrinsic, dtype=np.float64) @ np.asarray(extrinsic, dtype=np.float64) @ drop_z


def inverse_plane_homography(intrinsic: np.ndarray, extrinsic: np.ndarray, z: float = 0.0) -> np.ndarray:
    """3x3 homography: image pixels -> world plane at height ``z``.

    Mirrors `projection.py:37-43` (``get_worldcoord_from_imgcoord_mat``).
    """
    return np.linalg.inv(plane_homography(intrinsic, extrinsic, z))


def project_points(mat: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply a 3x3 projective transform to points of shape ``[..., 2]``.

    Mirrors `projection.py:4-14` (``project_2d_points``) but is shape-agnostic
    (points-last layout) and vectorized over leading axes.
    """
    points = np.asarray(points, dtype=np.float64)
    ones = np.ones(points.shape[:-1] + (1,), dtype=points.dtype)
    homo = np.concatenate([points, ones], axis=-1)  # [..., 3]
    out = homo @ np.asarray(mat, dtype=np.float64).T
    return out[..., :2] / out[..., 2:3]


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation vector -> 3x3 rotation matrix (axis-angle exponential map).

    Dependency-free replacement for ``cv2.Rodrigues`` as used at
    `datasets/Wildtrack.py:96`; matches it to float64 precision.
    """
    rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * kx + (1.0 - np.cos(theta)) * (kx @ kx)


def extrinsic_from_rvec_tvec(rvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """Build ``[R|t]`` (3x4) from a Rodrigues vector and translation."""
    R = rodrigues(rvec)
    t = np.asarray(tvec, dtype=np.float64).reshape(3, 1)
    return np.hstack([R, t])


def look_at_extrinsic(camera_pos: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Build an ``[R|t]`` extrinsic for a camera at ``camera_pos`` looking at ``target``.

    Used by the synthetic rig generator. The camera frame follows the OpenCV
    convention: +z forward (optical axis), +x right, +y down.
    """
    camera_pos = np.asarray(camera_pos, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    forward = target - camera_pos
    forward = forward / np.linalg.norm(forward)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(forward, up)
    nr = np.linalg.norm(right)
    if nr < 1e-9:  # looking straight down: pick an arbitrary right axis
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    down = np.cross(forward, right)
    down = down / np.linalg.norm(down)
    R = np.stack([right, down, forward], axis=0)  # world -> camera rotation
    t = -R @ camera_pos.reshape(3, 1)
    return np.hstack([R, t])


def pinhole_intrinsic(img_shape, fov_x_deg: float = 70.0) -> np.ndarray:
    """Simple pinhole intrinsics for an (H, W) image with the given horizontal FOV."""
    H, W = img_shape
    fx = (W / 2.0) / np.tan(np.deg2rad(fov_x_deg) / 2.0)
    return np.array([[fx, 0.0, W / 2.0], [0.0, fx, H / 2.0], [0.0, 0.0, 1.0]])
