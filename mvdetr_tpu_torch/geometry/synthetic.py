"""Synthetic calibrated camera rigs.

Provides self-contained rigs with known geometry so the full pipeline
(projection, warping, reference maps, target generation, training, CLEAR
evaluation) can be exercised and benchmarked without the Wildtrack /
MultiviewX assets on disk. The generated rigs follow the exact conventions of
the real dataset adapters (indexing, units, grid origin) so they double as
convention tests: a Wildtrack-style rig uses ij indexing, centimeter units and
an offset grid origin, a MultiviewX-style rig xy indexing and meters.

Copied unchanged (imports aside) from ``mvdetr_tpu/geometry/synthetic.py``; the port keeps its own
copy so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from mvdetr_tpu_torch.geometry.projection import look_at_extrinsic, pinhole_intrinsic
from mvdetr_tpu_torch.geometry.rig import CameraRig


def make_synthetic_rig(
    num_cam: int = 4,
    img_shape=(180, 320),
    worldgrid_shape=(120, 240),
    cell_meters: float = 0.025,
    indexing: str = "xy",
    worldcoord_unit: float = 1.0,
    origin_offset=(0.0, 0.0),
    camera_height_m: float = 3.5,
    camera_margin_m: float = 2.0,
    fov_x_deg: float = 75.0,
    name: str = "Synthetic",
) -> CameraRig:
    """Build a rig of ``num_cam`` cameras around a rectangular ground grid.

    Cameras sit on an ellipse just outside the grid at ``camera_height_m``,
    looking at the grid center, with OpenCV-convention extrinsics — the same
    form the real calibrations decode to (`datasets/Wildtrack.py:79-100`).

    ``worldcoord_unit`` scales the world coordinates the calibrations are
    expressed in (1.0 = meters, 0.01 = centimeters as in Wildtrack);
    ``origin_offset`` shifts the world origin in world-coordinate units.
    """
    n_row, n_col = worldgrid_shape
    cell = cell_meters / worldcoord_unit  # cell size in world-coordinate units
    ox, oy = origin_offset

    # worldgrid (dataset-native indexing) -> worldcoord, following the affine
    # layout of `datasets/Wildtrack.py:32` / `datasets/MultiviewX.py:32`.
    worldcoord_from_worldgrid = np.array([[cell, 0.0, ox], [0.0, cell, oy], [0.0, 0.0, 1.0]])

    # Ground extent in world units. Under xy indexing x spans the columns,
    # under ij it spans the rows.
    if indexing == "xy":
        extent = np.array([n_col * cell, n_row * cell])
    else:
        extent = np.array([n_row * cell, n_col * cell])
    center = np.array([ox + extent[0] / 2.0, oy + extent[1] / 2.0, 0.0])

    height = camera_height_m / worldcoord_unit
    margin = camera_margin_m / worldcoord_unit
    radii = extent / 2.0 + margin

    intr, extr = [], []
    for cam in range(num_cam):
        ang = 2.0 * np.pi * cam / num_cam + np.pi / num_cam
        pos = center + np.array([radii[0] * np.cos(ang), radii[1] * np.sin(ang), 0.0])
        pos[2] = height
        intr.append(pinhole_intrinsic(img_shape, fov_x_deg))
        # Aim slightly past the center so the horizon stays above the frame.
        target = center + 0.15 * (center - np.array([pos[0], pos[1], 0.0]))
        target[2] = 0.0
        extr.append(look_at_extrinsic(pos, target))

    return CameraRig(
        name=name,
        num_cam=num_cam,
        img_shape=tuple(img_shape),
        worldgrid_shape=tuple(worldgrid_shape),
        indexing=indexing,
        worldcoord_unit=worldcoord_unit,
        worldcoord_from_worldgrid_mat=worldcoord_from_worldgrid,
        intrinsic_matrices=np.stack(intr),
        extrinsic_matrices=np.stack(extr),
    )


def make_wildtrack_like_rig(num_cam: int = 7, img_shape=(180, 320), worldgrid_shape=(120, 360)) -> CameraRig:
    """A small rig with Wildtrack's conventions: ij indexing, cm units, offset origin."""
    return make_synthetic_rig(
        num_cam=num_cam,
        img_shape=img_shape,
        worldgrid_shape=worldgrid_shape,
        cell_meters=0.025,
        indexing="ij",
        worldcoord_unit=0.01,
        origin_offset=(-150.0, -450.0),
        name="SyntheticWildtrack",
    )
