"""Real dataset adapters: Wildtrack and MultiviewX, port of
``mvdetr_tpu/data/adapters.py`` (copied unchanged but for the image decode).

File-format and convention contracts from the original MVDeTr's
``multiview_detector/datasets/Wildtrack.py`` and ``datasets/MultiviewX.py``:

- intrinsics from OpenCV FileStorage XML (``camera_matrix`` node),
- extrinsics from rvec/tvec (Rodrigues) — Wildtrack stores them as raw XML
  text nodes (`Wildtrack.py:87-94`), MultiviewX as FileStorage mats
  (`MultiviewX.py:87-92`),
- Wildtrack: 7 cams, 1080x1920, 480x1440 grid, ij indexing, centimeters,
  origin (-300, -900) (`Wildtrack.py:21-32`),
- MultiviewX: 6 cams, 1080x1920, 640x1000 grid, xy indexing, meters
  (`MultiviewX.py:21-32`),
- per-frame JSON annotations ``annotations_positions/*.json`` with
  ``positionID``, ``personID`` and per-view bboxes (-1 = not visible)
  (`frameDataset.py:90-127`),
- POM rectangles for self-tests (`Wildtrack.py:102-118`).

A ``.png`` frame always decodes through the port's own codec
(:func:`mvdetr_tpu_torch.data.png.decode_png`: ``zlib`` and the native
library), on every machine, so a PNG tree gives the same bytes by the same
code here and on the card's machine, which has neither cv2 nor PIL. Other
formats (JPEG) decode with cv2 where it is installed, else PIL, else
:func:`load_image_rgb` raises: this is the only module of the port's data
path that imports either.
"""

from __future__ import annotations

import json
import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from mvdetr_tpu_torch.data.png import decode_png
from mvdetr_tpu_torch.data.source import FrameAnnotation
from mvdetr_tpu_torch.geometry.projection import extrinsic_from_rvec_tvec
from mvdetr_tpu_torch.geometry.rig import CameraRig

_WILDTRACK_INTR = ["intr_CVLab1.xml", "intr_CVLab2.xml", "intr_CVLab3.xml", "intr_CVLab4.xml",
                   "intr_IDIAP1.xml", "intr_IDIAP2.xml", "intr_IDIAP3.xml"]
_WILDTRACK_EXTR = ["extr_CVLab1.xml", "extr_CVLab2.xml", "extr_CVLab3.xml", "extr_CVLab4.xml",
                   "extr_IDIAP1.xml", "extr_IDIAP2.xml", "extr_IDIAP3.xml"]
_MULTIVIEWX_INTR = [f"intr_Camera{i}.xml" for i in range(1, 7)]
_MULTIVIEWX_EXTR = [f"extr_Camera{i}.xml" for i in range(1, 7)]


def load_image_rgb(path: str) -> np.ndarray:
    """Decode to RGB uint8. A ``.png`` goes through :func:`decode_png`
    (never cv2 or PIL); any other file through cv2 where it is installed
    (it decodes outside the interpreter lock, so the threaded loader
    scales), else PIL; with neither, raises."""
    if path.lower().endswith(".png"):
        return decode_png(path)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise OSError(f"cv2 could not read {path}")
        return np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"reading {path} needs cv2 or PIL (Pillow); neither is installed") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _read_opencv_matrix(path: str, node: str) -> np.ndarray:
    """Parse an OpenCV FileStorage XML matrix without requiring cv2."""
    root = ET.parse(path).getroot()
    el = root.find(node)
    if el is None:
        raise KeyError(f"{node} not found in {path}")
    rows = int(el.findtext("rows"))
    cols = int(el.findtext("cols"))
    data = np.asarray([float(v) for v in el.findtext("data").split()])
    return data.reshape(rows, cols)


def _read_vector_node(path: str, node: str) -> np.ndarray:
    root = ET.parse(path).getroot()
    el = root.findall(node)[0]
    if el.find("data") is not None:  # FileStorage-matrix style
        return np.asarray([float(v) for v in el.findtext("data").split()])
    return np.asarray([float(v) for v in el.text.strip().split()])


class _RealSceneBase:
    """Shared image/annotation access (`frameDataset.py:83-131`, `Wildtrack.py:36-46`)."""

    rig: CameraRig
    num_frame: int

    def __init__(self, root: str):
        self.root = root
        self._images: Dict[int, Dict[int, str]] = {}
        img_dir = os.path.join(root, "Image_subsets")
        if os.path.isdir(img_dir):
            for camera_folder in sorted(os.listdir(img_dir)):
                cam = int(camera_folder[-1]) - 1
                if cam >= self.rig.num_cam:
                    continue
                self._images[cam] = {}
                for fname in sorted(os.listdir(os.path.join(img_dir, camera_folder))):
                    self._images[cam][int(fname.split(".")[0])] = os.path.join(img_dir, camera_folder, fname)
        self._ann_dir = os.path.join(root, "annotations_positions")
        self._ann_files: Dict[int, str] = {}
        if os.path.isdir(self._ann_dir):
            for f in sorted(os.listdir(self._ann_dir)):
                if f.endswith(".json"):
                    self._ann_files[int(f.split(".")[0])] = os.path.join(self._ann_dir, f)

    def frames(self) -> List[int]:
        return sorted(self._ann_files)

    def annotation(self, frame: int) -> FrameAnnotation:
        with open(self._ann_files[frame]) as fh:
            people = json.load(fh)
        pts, pids = [], []
        bboxes = [[] for _ in range(self.rig.num_cam)]
        bbox_pids = [[] for _ in range(self.rig.num_cam)]
        for person in people:
            grid = self.rig.worldgrid_from_pos(np.asarray(person["positionID"]))
            pts.append(grid.astype(np.float64))
            pids.append(person["personID"])
            for cam in range(self.rig.num_cam):
                v = person["views"][cam]
                box = (v["xmin"], v["ymin"], v["xmax"], v["ymax"])
                if box != (-1, -1, -1, -1):
                    bboxes[cam].append(np.asarray(box, dtype=np.float64))
                    bbox_pids[cam].append(person["personID"])
        return FrameAnnotation(
            world_pts=np.asarray(pts).reshape(-1, 2),
            pids=np.asarray(pids, dtype=np.int64),
            bboxes=[np.asarray(b).reshape(-1, 4) for b in bboxes],
            bbox_pids=[np.asarray(b, dtype=np.int64) for b in bbox_pids],
        )

    def image(self, cam: int, frame: int) -> np.ndarray:
        return load_image_rgb(self._images[cam][frame])

    def read_pom(self) -> dict:
        """rectangles.pom parser (`Wildtrack.py:102-118`)."""
        bbox_by_pos_cam: dict = {}
        cam_pos = re.compile(r"(\d+) (\d+)")
        cam_pos_bbox = re.compile(r"(\d+) (\d+) ([-\d]+) ([-\d]+) (\d+) (\d+)")
        hgt, wid = self.rig.img_shape
        with open(os.path.join(self.root, "rectangles.pom")) as fp:
            for line in fp:
                if "RECTANGLE" not in line:
                    continue
                cam, pos = map(int, cam_pos.search(line).groups())
                bbox_by_pos_cam.setdefault(pos, {})
                if "notvisible" in line:
                    bbox_by_pos_cam[pos][cam] = None
                else:
                    cam, pos, left, top, right, bottom = map(int, cam_pos_bbox.search(line).groups())
                    bbox_by_pos_cam[pos][cam] = [max(left, 0), max(top, 0), min(right, wid - 1), min(bottom, hgt - 1)]
        return bbox_by_pos_cam


class WildtrackScene(_RealSceneBase):
    def __init__(self, root: str):
        intr, extr = [], []
        for i in range(7):
            intr.append(_read_opencv_matrix(
                os.path.join(root, "calibrations", "intrinsic_zero", _WILDTRACK_INTR[i]), "camera_matrix"))
            epath = os.path.join(root, "calibrations", "extrinsic", _WILDTRACK_EXTR[i])
            rvec = _read_vector_node(epath, "rvec")
            tvec = _read_vector_node(epath, "tvec")
            extr.append(extrinsic_from_rvec_tvec(rvec, tvec))
        self.rig = CameraRig(
            name="Wildtrack",
            num_cam=7,
            img_shape=(1080, 1920),
            worldgrid_shape=(480, 1440),
            indexing="ij",
            worldcoord_unit=0.01,
            worldcoord_from_worldgrid_mat=np.array([[2.5, 0, -300], [0, 2.5, -900], [0, 0, 1]]),
            intrinsic_matrices=np.stack(intr),
            extrinsic_matrices=np.stack(extr),
        )
        self.num_frame = 2000
        super().__init__(root)


class MultiviewXScene(_RealSceneBase):
    def __init__(self, root: str):
        intr, extr = [], []
        for i in range(6):
            intr.append(_read_opencv_matrix(
                os.path.join(root, "calibrations", "intrinsic", _MULTIVIEWX_INTR[i]), "camera_matrix"))
            epath = os.path.join(root, "calibrations", "extrinsic", _MULTIVIEWX_EXTR[i])
            rvec = _read_vector_node(epath, "rvec")
            tvec = _read_vector_node(epath, "tvec")
            extr.append(extrinsic_from_rvec_tvec(rvec, tvec))
        self.rig = CameraRig(
            name="MultiviewX",
            num_cam=6,
            img_shape=(1080, 1920),
            worldgrid_shape=(640, 1000),
            indexing="xy",
            worldcoord_unit=1.0,
            worldcoord_from_worldgrid_mat=np.array([[0.025, 0, 0], [0, 0.025, 0], [0, 0, 1]]),
            intrinsic_matrices=np.stack(intr),
            extrinsic_matrices=np.stack(extr),
        )
        self.num_frame = 400
        super().__init__(root)


def open_scene(name_or_root: str):
    """'wildtrack'/'multiviewx' (under ~/Data) or an explicit dataset root."""
    lowered = name_or_root.lower()
    if "wildtrack" in lowered:
        root = name_or_root if os.path.isdir(name_or_root) else os.path.expanduser("~/Data/Wildtrack")
        return WildtrackScene(root)
    if "multiviewx" in lowered:
        root = name_or_root if os.path.isdir(name_or_root) else os.path.expanduser("~/Data/MultiviewX")
        return MultiviewXScene(root)
    raise ValueError(f"unknown dataset: {name_or_root}")
