"""The camera rig and every matrix derived from it, in plain numpy.

A frozen copy of the planar geometry the MVDeTr paper uses
(`multiview_detector/utils/projection.py`, `models/mvdetr.py:33-95`): a
camera with intrinsics ``K`` and extrinsics ``[R|t]`` maps the ground plane at
height ``z`` to image pixels by ``K [R|t] [[1,0,0],[0,1,0],[0,0,z],[0,0,1]]``.
The synthetic rig is the ``bench_rig`` layout: cameras on an ellipse 4 m
outside a Wildtrack-sized grid, 6 m up, looking past its centre.

A rig is a plain dict (see :func:`make_rig`), so both sides of the
comparison are handed the same numbers.
"""

from __future__ import annotations

import numpy as np

SWAP_XY = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def pinhole_intrinsic(img_shape, fov_x_deg: float) -> np.ndarray:
    h, w = img_shape
    fx = (w / 2.0) / np.tan(np.deg2rad(fov_x_deg) / 2.0)
    return np.array([[fx, 0.0, w / 2.0], [0.0, fx, h / 2.0], [0.0, 0.0, 1.0]])


def look_at_extrinsic(camera_pos, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenCV-convention ``[R|t]`` of a camera at ``camera_pos`` looking at ``target``."""
    camera_pos = np.asarray(camera_pos, dtype=np.float64)
    forward = np.asarray(target, dtype=np.float64) - camera_pos
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, dtype=np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(forward, right)
    down = down / np.linalg.norm(down)
    rot = np.stack([right, down, forward], axis=0)
    return np.hstack([rot, -rot @ camera_pos.reshape(3, 1)])


def make_rig(num_cam: int, img_shape, worldgrid_shape, cell_meters: float, indexing: str, worldcoord_unit: float,
             origin_offset, camera_height_m: float, camera_margin_m: float, fov_x_deg: float) -> dict:
    """``num_cam`` cameras around a ``worldgrid_shape`` ground grid of
    ``cell_meters`` cells (dataset-native ``indexing``, world coordinates in
    units of ``worldcoord_unit`` metres from ``origin_offset``)."""
    n_row, n_col = worldgrid_shape
    cell = cell_meters / worldcoord_unit
    ox, oy = origin_offset
    extent = np.array([n_col * cell, n_row * cell]) if indexing == "xy" else np.array([n_row * cell, n_col * cell])
    center = np.array([ox + extent[0] / 2.0, oy + extent[1] / 2.0, 0.0])
    radii = extent / 2.0 + camera_margin_m / worldcoord_unit
    intr, extr = [], []
    for cam in range(num_cam):
        ang = 2.0 * np.pi * cam / num_cam + np.pi / num_cam
        pos = center + np.array([radii[0] * np.cos(ang), radii[1] * np.sin(ang), 0.0])
        pos[2] = camera_height_m / worldcoord_unit
        target = center + 0.15 * (center - np.array([pos[0], pos[1], 0.0]))
        target[2] = 0.0
        intr.append(pinhole_intrinsic(img_shape, fov_x_deg))
        extr.append(look_at_extrinsic(pos, target))
    return {"num_cam": num_cam, "img_shape": tuple(img_shape), "worldgrid_shape": tuple(worldgrid_shape),
            "indexing": indexing, "worldcoord_unit": worldcoord_unit,
            "worldcoord_from_worldgrid": np.array([[cell, 0.0, ox], [0.0, cell, oy], [0.0, 0.0, 1.0]]),
            "intrinsics": np.stack(intr), "extrinsics": np.stack(extr)}


def project(mat: np.ndarray, points: np.ndarray) -> np.ndarray:
    """A 3x3 projective map of points ``[..., 2]``, in f64."""
    points = np.asarray(points, dtype=np.float64)
    homo = np.concatenate([points, np.ones(points.shape[:-1] + (1,))], axis=-1) @ np.asarray(mat, np.float64).T
    return homo[..., :2] / homo[..., 2:3]


def plane_homography(rig: dict, cam: int, z_meters: float) -> np.ndarray:
    """Ground plane at ``z_meters`` (world units) -> image pixels of ``cam``."""
    drop_z = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, z_meters / rig["worldcoord_unit"]], [0, 0, 1.0]])
    return rig["intrinsics"][cam] @ rig["extrinsics"][cam] @ drop_z


def grid_from_worldcoord(rig: dict, world_reduce: int, downsample: int = 1) -> np.ndarray:
    """World coordinates -> the reduced, xy-indexed BEV grid."""
    swap = np.eye(3) if rig["indexing"] == "xy" else SWAP_XY
    zoom = np.diag([world_reduce * downsample, world_reduce * downsample, 1.0])
    return np.linalg.inv(rig["worldcoord_from_worldgrid"] @ zoom @ swap)


def proj_mats(rig: dict, world_reduce: int) -> np.ndarray:
    """``[N, 3, 3]``: full-resolution image pixels -> reduced BEV grid cells."""
    base = grid_from_worldcoord(rig, world_reduce)
    return np.stack([base @ np.linalg.inv(plane_homography(rig, c, 0.0)) for c in range(rig["num_cam"])])


def img_from_world(rig: dict, z_meters: float) -> np.ndarray:
    """``[N, 3, 3]``: the full-resolution xy world grid -> image pixels."""
    base = grid_from_worldcoord(rig, 1)
    return np.stack([np.linalg.inv(base @ np.linalg.inv(plane_homography(rig, c, z_meters)))
                     for c in range(rig["num_cam"])])


def reference_points(rig: dict, world_reduce: int, downsample: int, n_points: int) -> np.ndarray:
    """The per-cell, per-camera reference map of the encoder grid
    (`models/mvdetr.py:33-71`), ``[Hs*Ws, N, P, 2]`` f32 normalised by
    ``(Ws, Hs)``: each cell lifted to height z through the camera and dropped
    back to the ground. At ``n_points=4`` every height is 0: the identity
    grid up to rounding."""
    if n_points != 4:
        raise ValueError("the frozen reference map covers n_points=4 (every height 0)")
    h, w = (s // world_reduce // downsample for s in rig["worldgrid_shape"])
    ys, xs = np.meshgrid(np.linspace(0.5, h - 0.5, h), np.linspace(0.5, w - 0.5, w), indexing="ij")
    ref = np.stack([xs, ys], axis=-1).reshape(-1, 2)
    grid = grid_from_worldcoord(rig, world_reduce, downsample)
    out = np.zeros([h * w, rig["num_cam"], n_points, 2], dtype=np.float32)
    for cam in range(rig["num_cam"]):
        mat = grid @ np.linalg.inv(plane_homography(rig, cam, 0.0))
        img_pts = project(np.linalg.inv(mat), ref)
        out[:, cam, :, :] = project(mat, img_pts).astype(np.float32)[:, None, :]
    out[..., 0] /= w
    out[..., 1] /= h
    return out


def sine_pos_embedding(h: int, w: int, num_pos_feats: int, temperature: float = 10000.0) -> np.ndarray:
    """DETR's normalised sine embedding ``[H, W, 2 * num_pos_feats]`` f32,
    y features then x features (`trans_world_feat.py:15-37`)."""
    scale, eps = 2.0 * np.pi, 1e-6
    y_embed = np.cumsum(np.ones((h, w)), axis=0)
    x_embed = np.cumsum(np.ones((h, w)), axis=1)
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = temperature ** (2.0 * (np.arange(num_pos_feats) // 2) / num_pos_feats)
    pos_x, pos_y = x_embed[:, :, None] / dim_t, y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=2).astype(np.float32)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` weights of a bilinear resize at half-pixel centres
    with the edge taps renormalised (``jax.image.resize``'s "bilinear", the
    encoder's upsample)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(n_in)[None, :]) / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total > 0, w / np.where(total > 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)
