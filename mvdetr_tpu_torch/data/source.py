"""Scene sources — uniform access to frames, annotations, and calibration.

Copied unchanged (imports aside) from ``mvdetr_tpu/data/source.py``: the same
seed gives the same tracks, annotations and rendered images.

A ``SceneSource`` provides what `frameDataset` reads from disk in the
original MVDeTr (`multiview_detector/datasets/frameDataset.py:83-127`):
images per (cam, frame), per-frame world positions + per-camera bboxes, and
the calibrated :class:`CameraRig`. Implementations: the real dataset adapters
(:mod:`mvdetr_tpu_torch.data.adapters`) and the synthetic scene below.

The synthetic scene renders persons as colored vertical "capsules" whose
image placement is derived from the same projective geometry the model uses —
so a model trained on it can only succeed if the whole geometry/warp/decode
chain is consistent. This stands in for Wildtrack/MultiviewX in tests and
benchmarks when the real assets are absent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol

import numpy as np

from mvdetr_tpu_torch.geometry.projection import project_points
from mvdetr_tpu_torch.geometry.rig import CameraRig


@dataclasses.dataclass
class FrameAnnotation:
    """World positions in dataset-native grid units + per-cam x1y1x2y2 boxes."""

    world_pts: np.ndarray  # [n, 2] dataset-native grid (x, y)
    pids: np.ndarray  # [n]
    bboxes: List[np.ndarray]  # num_cam entries of [n_cam_i, 4]
    bbox_pids: List[np.ndarray]  # matching person ids per camera


class SceneSource(Protocol):
    rig: CameraRig
    num_frame: int

    def frames(self) -> List[int]: ...

    def annotation(self, frame: int) -> FrameAnnotation: ...

    def image(self, cam: int, frame: int) -> np.ndarray: ...


class SyntheticScene:
    """Random-walking synthetic pedestrians on a calibrated rig."""

    def __init__(
        self,
        rig: CameraRig,
        num_frame: int = 40,
        num_person: int = 8,
        person_height_m: float = 1.8,
        person_width_m: float = 0.5,
        seed: int = 2021,
        step_cells: float = 3.0,
        cache_images: bool = True,
    ):
        self.rig = rig
        self.num_frame = num_frame
        self.num_person = num_person
        self.person_height_m = person_height_m
        self.person_width_m = person_width_m
        self._cache_images = cache_images
        rng = np.random.default_rng(seed)

        h, w = rig.worldgrid_shape
        # native-x spans rows under ij indexing, cols under xy
        x_max, y_max = (h, w) if rig.indexing == "ij" else (w, h)
        pos = rng.uniform([x_max * 0.1, y_max * 0.1], [x_max * 0.9, y_max * 0.9], (num_person, 2))
        self._tracks = np.zeros((num_frame, num_person, 2))
        for t in range(num_frame):
            pos = pos + rng.normal(0, step_cells, (num_person, 2))
            pos = np.clip(pos, [0, 0], [x_max - 1, y_max - 1])
            self._tracks[t] = pos
        self._colors = rng.uniform(0.35, 1.0, (num_person, 3))
        self._cache: Dict[tuple, np.ndarray] = {}
        self._ann_cache: Dict[int, FrameAnnotation] = {}

    # ------------------------------------------------------------ geometry
    def _project_person(self, cam: int, world_grid_xy: np.ndarray):
        """Foot/head/side image points of a person standing at a grid cell."""
        rig = self.rig
        wc = rig.worldcoord_from_worldgrid(world_grid_xy[None])[0]
        foot = project_points(rig.imgcoord_from_worldcoord_mat(cam, 0.0), wc[None])[0]
        head = project_points(rig.imgcoord_from_worldcoord_mat(cam, self.person_height_m), wc[None])[0]
        half_w = self.person_width_m / 2.0 / rig.worldcoord_unit
        side_a = project_points(rig.imgcoord_from_worldcoord_mat(cam, 0.0), (wc + [half_w, 0.0])[None])[0]
        side_b = project_points(rig.imgcoord_from_worldcoord_mat(cam, 0.0), (wc - [half_w, 0.0])[None])[0]
        return foot, head, side_a, side_b

    def _bbox(self, cam: int, world_grid_xy: np.ndarray) -> Optional[np.ndarray]:
        hgt, wid = self.rig.img_shape
        foot, head, sa, sb = self._project_person(cam, world_grid_xy)
        if not np.all(np.isfinite([foot, head, sa, sb])):
            return None
        # behind-camera check: point must be in front (positive depth)
        rig = self.rig
        wc = rig.worldcoord_from_worldgrid(world_grid_xy[None])[0]
        xyz = np.array([wc[0], wc[1], 0.0, 1.0])
        depth = (rig.extrinsic_matrices[cam] @ xyz)[2]
        if depth <= 0:
            return None
        half = abs(sa[0] - sb[0]) / 2.0
        x1, x2 = foot[0] - half, foot[0] + half
        y1, y2 = min(head[1], foot[1]), max(head[1], foot[1])
        if x2 < 0 or x1 > wid - 1 or y2 < 0 or y1 > hgt - 1:
            return None
        return np.array([max(x1, 0), max(y1, 0), min(x2, wid - 1), min(y2, hgt - 1)])

    # ------------------------------------------------------------ interface
    def frames(self) -> List[int]:
        return list(range(self.num_frame))

    def annotation(self, frame: int) -> FrameAnnotation:
        if frame in self._ann_cache:
            return self._ann_cache[frame]
        pts, pids = [], []
        bboxes = [[] for _ in range(self.rig.num_cam)]
        bbox_pids = [[] for _ in range(self.rig.num_cam)]
        for p in range(self.num_person):
            grid = self._tracks[frame, p]
            visible = 0
            cam_boxes = {}
            for cam in range(self.rig.num_cam):
                bb = self._bbox(cam, grid)
                if bb is not None:
                    cam_boxes[cam] = bb
                    visible += 1
            if visible == 0:
                continue
            pts.append(grid)
            pids.append(p)
            for cam, bb in cam_boxes.items():
                bboxes[cam].append(bb)
                bbox_pids[cam].append(p)
        ann = FrameAnnotation(
            world_pts=np.asarray(pts).reshape(-1, 2),
            pids=np.asarray(pids, dtype=np.int64),
            bboxes=[np.asarray(b).reshape(-1, 4) for b in bboxes],
            bbox_pids=[np.asarray(b, dtype=np.int64) for b in bbox_pids],
        )
        self._ann_cache[frame] = ann
        return ann

    def image(self, cam: int, frame: int) -> np.ndarray:
        key = (cam, frame)
        if key in self._cache:
            return self._cache[key]
        hgt, wid = self.rig.img_shape
        rng = np.random.default_rng(hash((cam, frame)) % (2**31))
        img = (rng.uniform(0.05, 0.15, (hgt, wid, 3)) * 255).astype(np.float32)

        ann = self.annotation(frame)
        # paint far-to-near so nearer persons occlude (approx: by bbox height)
        order = np.argsort([b[3] - b[1] for b in ann.bboxes[cam]]) if len(ann.bboxes[cam]) else []
        for j in order:
            x1, y1, x2, y2 = ann.bboxes[cam][j]
            pid = ann.bbox_pids[cam][j]
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            rx, ry = max((x2 - x1) / 2, 1.0), max((y2 - y1) / 2, 1.0)
            # the ellipse is inscribed in its (clipped) bbox — evaluate the
            # mask on the bbox slice only, not the full frame
            ix1, iy1 = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
            ix2, iy2 = min(int(np.ceil(x2)) + 1, wid), min(int(np.ceil(y2)) + 1, hgt)
            if ix2 <= ix1 or iy2 <= iy1:
                continue
            lys, lxs = np.ogrid[iy1:iy2, ix1:ix2]
            mask = ((lxs - cx) / rx) ** 2 + ((lys - cy) / ry) ** 2 <= 1.0
            img[iy1:iy2, ix1:ix2][mask] = self._colors[pid] * 255
        img = np.clip(img, 0, 255).astype(np.uint8)
        if self._cache_images:
            self._cache[key] = img
        return img
