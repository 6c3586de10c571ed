"""CameraRig — the single geometry object the whole framework consumes.

A rig bundles the calibrated cameras of a scene together with the ground-grid
conventions of its dataset, and exposes every derived matrix the model, data
pipeline, and visualizers need:

- ``proj_mats(world_reduce)``: per-camera 3x3 homographies mapping full-res
  image pixels to the reduced BEV grid (xy-indexed) — the warp matrices
  (contract: `multiview_detector/models/mvdetr.py:82-95`),
- ``world_from_img()`` / ``img_from_world()``: full-resolution grid <-> image
  homographies used for masks and GT (`datasets/frameDataset.py:135-153`),
- ``reference_points(...)``: the per-BEV-cell, per-camera "shadow" reference
  maps that seed deformable attention (`models/mvdetr.py:33-71`).

Dataset quirks preserved (see `datasets/Wildtrack.py:21-32` and
`datasets/MultiviewX.py:21-32`):
- ``indexing``: Wildtrack stores its ground grid "ij"-indexed (x is the row),
  MultiviewX "xy"-indexed; internally everything is computed in xy indexing
  and converted through ``world_indexing_from_xy_mat``.
- ``worldcoord_unit``: meters per world-coordinate unit (0.01 for Wildtrack's
  centimeter calibrations). Heights in meters are divided by this before
  entering homographies (`models/mvdetr.py:90`).

Copied unchanged (imports aside) from ``mvdetr_tpu/geometry/rig.py``; the port keeps its own
copy so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from mvdetr_tpu_torch.geometry.projection import inverse_plane_homography, project_points

_SWAP_XY = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

# Default relative sampling heights (meters) for the 8-point reference map,
# matching `models/mvdetr.py:39-44`.
REFERENCE_ZS = {4: (0.0, 0.0, 0.0, 0.0), 8: (-0.4, -0.2, 0.0, 0.0, 0.2, 0.4, 1.0, 1.8)}


@dataclasses.dataclass(frozen=True)
class CameraRig:
    name: str
    num_cam: int
    img_shape: tuple  # (H, W) pixels
    worldgrid_shape: tuple  # (N_row, N_col) ground cells
    indexing: str  # 'xy' | 'ij'
    worldcoord_unit: float  # meters per world-coordinate unit
    worldcoord_from_worldgrid_mat: np.ndarray  # 3x3
    intrinsic_matrices: np.ndarray  # [N, 3, 3]
    extrinsic_matrices: np.ndarray  # [N, 3, 4]

    def __post_init__(self):
        assert self.indexing in ("xy", "ij"), self.indexing
        assert self.intrinsic_matrices.shape == (self.num_cam, 3, 3)
        assert self.extrinsic_matrices.shape == (self.num_cam, 3, 4)

    # ------------------------------------------------------------------ grids
    @property
    def world_indexing_from_xy_mat(self) -> np.ndarray:
        return np.eye(3) if self.indexing == "xy" else _SWAP_XY.copy()

    @property
    def pos_stride(self) -> int:
        """Stride of the scalar positionID encoding: ``pos = x + y * stride``.

        Wildtrack encodes pos over its (row-major under ij indexing) 480-wide
        axis (`datasets/Wildtrack.py:48-55`), MultiviewX over its 1000-wide
        x axis (`datasets/MultiviewX.py:48-55`); both equal the size of the
        dataset-native x axis.
        """
        return int(self.worldgrid_shape[0] if self.indexing == "ij" else self.worldgrid_shape[1])

    def worldgrid_from_pos(self, pos) -> np.ndarray:
        """positionID -> dataset-native (grid_x, grid_y), shape [..., 2]."""
        pos = np.asarray(pos)
        return np.stack([pos % self.pos_stride, pos // self.pos_stride], axis=-1)

    def pos_from_worldgrid(self, grid) -> np.ndarray:
        grid = np.asarray(grid)
        return grid[..., 0] + grid[..., 1] * self.pos_stride

    def worldcoord_from_worldgrid(self, grid) -> np.ndarray:
        """Dataset-native grid [..., 2] -> world coordinates [..., 2]."""
        return project_points(self.worldcoord_from_worldgrid_mat, grid)

    def worldgrid_from_worldcoord(self, coord) -> np.ndarray:
        return project_points(np.linalg.inv(self.worldcoord_from_worldgrid_mat), coord)

    # ------------------------------------------------------- derived matrices
    def Rworldgrid_from_worldcoord_mat(self, world_reduce: int = 1, downsample: int = 1) -> np.ndarray:
        """World coords -> reduced, xy-indexed BEV grid (`mvdetr.py:82-84`)."""
        zoom = np.diag([world_reduce * downsample, world_reduce * downsample, 1.0])
        return np.linalg.inv(self.worldcoord_from_worldgrid_mat @ zoom @ self.world_indexing_from_xy_mat)

    def imgcoord_from_worldcoord_mat(self, cam: int, z_meters: float = 0.0) -> np.ndarray:
        from mvdetr_tpu_torch.geometry.projection import plane_homography

        return plane_homography(
            self.intrinsic_matrices[cam], self.extrinsic_matrices[cam], z_meters / self.worldcoord_unit
        )

    def worldcoord_from_imgcoord_mat(self, cam: int, z_meters: float = 0.0) -> np.ndarray:
        return inverse_plane_homography(
            self.intrinsic_matrices[cam], self.extrinsic_matrices[cam], z_meters / self.worldcoord_unit
        )

    def proj_mats(self, world_reduce: int = 4, z_meters: float = 0.0) -> np.ndarray:
        """[N, 3, 3] homographies: image pixels -> reduced xy BEV grid.

        The per-sample augmentation inverse and the image-reduce scaling are
        composed on device at forward time (`mvdetr.py:155-161` contract).
        """
        base = self.Rworldgrid_from_worldcoord_mat(world_reduce)
        return np.stack([base @ self.worldcoord_from_imgcoord_mat(cam, z_meters) for cam in range(self.num_cam)])

    def world_from_img(self, z_meters: float = 0.0) -> np.ndarray:
        """[N, 3, 3]: image pixels -> full-res xy world grid (`frameDataset.py:135-153`)."""
        return self.proj_mats(world_reduce=1, z_meters=z_meters)

    def img_from_world(self, z_meters: float = 0.0) -> np.ndarray:
        return np.stack([np.linalg.inv(m) for m in self.world_from_img(z_meters)])

    # ------------------------------------------------------- reference points
    def Rworld_shape(self, world_reduce: int) -> tuple:
        return (self.worldgrid_shape[0] // world_reduce, self.worldgrid_shape[1] // world_reduce)

    def reference_points(self, world_reduce: int = 4, downsample: int = 2, n_points: int = 4) -> np.ndarray:
        """Per-BEV-cell, per-camera deformable reference points.

        Re-derivation of `models/mvdetr.py:33-71` (``create_reference_map``):
        each BEV cell is lifted to height ``z`` through camera ``cam`` (world
        -> image at z, image -> world at 0), tracing the camera's vertical
        "shadow" ray on the ground. For ``n_points == 4`` all heights are 0 so
        the map is the identity (up to numerics); for 8 points heights span
        -0.4m..1.8m.

        Returns ``[H*W, num_cam, n_points, 2]`` float32, normalized to [0, 1]
        by (W, H) of the downsampled BEV grid. Row-major over (y, x).
        """
        H, W = self.Rworld_shape(world_reduce)
        H, W = H // downsample, W // downsample
        ys, xs = np.meshgrid(np.linspace(0.5, H - 0.5, H), np.linspace(0.5, W - 0.5, W), indexing="ij")
        ref = np.stack([xs, ys], axis=-1).reshape(-1, 2)  # [H*W, 2] in grid units

        zs = REFERENCE_ZS.get(n_points)
        if zs is None:
            raise ValueError(f"n_points must be one of {sorted(REFERENCE_ZS)}, got {n_points}")

        grid_from_coord = self.Rworldgrid_from_worldcoord_mat(world_reduce, downsample)
        out = np.zeros([H * W, self.num_cam, n_points, 2], dtype=np.float32)
        for cam in range(self.num_cam):
            mat_0 = grid_from_coord @ self.worldcoord_from_imgcoord_mat(cam, 0.0)
            for i, z in enumerate(zs):
                mat_z = grid_from_coord @ self.worldcoord_from_imgcoord_mat(cam, z)
                img_pts = project_points(np.linalg.inv(mat_z), ref)
                out[:, cam, i, :] = project_points(mat_0, img_pts).astype(np.float32)
        out[..., 0] /= W
        out[..., 1] /= H
        return out

    def shadow_reach_cells(self, world_reduce: int = 4, downsample: int = 2) -> tuple:
        """(median, p95) over BEV cells/cameras of the farthest 8-point shadow
        reference's distance from the z=0 reference, in downsampled grid cells.

        This is the distance a 4-point model's *learned offsets* must span to
        aggregate head-height evidence when its reference points all sit at
        z=0 — i.e. how far the windowed clamp radius is from sufficient.
        Low cameras stretch shadows: the BENCH_NOTES clamp-stress rig
        (4 cams at 2 m) measures median ~178 cells vs ~36 for a
        Wildtrack-like rig (7 cams at 6 m), where radius-4 at 4 points loses
        2.5 MODA vs ~0 respectively.
        """
        ref = self.reference_points(world_reduce=world_reduce, downsample=downsample, n_points=8)
        h, w = self.Rworld_shape(world_reduce)
        h, w = h // downsample, w // downsample
        pts = ref * np.array([w, h])
        z0 = pts[:, :, 2:4].mean(2, keepdims=True)  # REFERENCE_ZS[8] indices 2,3 are z=0
        d = np.linalg.norm(pts - z0, axis=-1).max(-1)
        return float(np.percentile(d, 50)), float(np.percentile(d, 95))

    # ---------------------------------------------------------------- caches
    @cached_property
    def _world_from_img_z0(self) -> np.ndarray:
        return self.world_from_img(0.0)
