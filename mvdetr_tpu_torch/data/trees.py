"""On-disk dataset-format tree writers, copied from the repo's
``tests/_fixture_trees.py``.

Generate complete Wildtrack- and MultiviewX-format directory trees (OpenCV
FileStorage calibration XMLs, JSON position annotations, ``Image_subsets``
frames) from a :class:`~mvdetr_tpu_torch.data.SyntheticScene`, so the exact
day-one command path -- ``python -m mvdetr_tpu_torch.cli -d wildtrack
--data_root <tree>`` through the real adapters -- runs end to end without
the real (licensed) assets.

The one change from the file it was copied from is the image format: the
frames are lossless PNGs, ``{frame:08d}.png``, written by
:func:`mvdetr_tpu_torch.data.png.encode_png` (the copied file writes JPEGs
through PIL), so a tree is written and read on a machine without cv2 and
PIL and decodes to the scene's own renders, byte for byte. The calibration
and annotation files are the same bytes; their file names come from the
port's adapters.

Format contracts: the original MVDeTr's ``datasets/Wildtrack.py:36-118``
(raw-text rvec/tvec nodes, ``intrinsic_zero`` folder, C1..C7 image folders,
8-digit frame JSONs) and ``datasets/MultiviewX.py:36-98`` (FileStorage-matrix
rvec/tvec, ``intrinsic`` folder).
"""

from __future__ import annotations

import json
import os

import numpy as np

from mvdetr_tpu_torch.data.adapters import _MULTIVIEWX_EXTR, _MULTIVIEWX_INTR, _WILDTRACK_EXTR, _WILDTRACK_INTR
from mvdetr_tpu_torch.data.png import write_png
from mvdetr_tpu_torch.data.source import SyntheticScene
from mvdetr_tpu_torch.geometry.synthetic import make_synthetic_rig


def opencv_matrix_xml(name, mat) -> str:
    mat = np.asarray(mat, dtype=np.float64)
    rows, cols = mat.shape
    data = " ".join(f"{v:.17g}" for v in mat.reshape(-1))
    return (
        f'<?xml version="1.0"?>\n<opencv_storage>\n<{name} type_id="opencv-matrix">\n'
        f"  <rows>{rows}</rows>\n  <cols>{cols}</cols>\n  <dt>d</dt>\n"
        f"  <data>\n    {data}</data></{name}>\n</opencv_storage>\n"
    )


def rvec_tvec_xml_raw(rvec, tvec) -> str:
    """Wildtrack style: raw whitespace-separated text nodes (`Wildtrack.py:87-94`)."""
    rtxt = " ".join(f"{v:.17g}" for v in rvec)
    ttxt = " ".join(f"{v:.17g}" for v in tvec)
    return (
        '<?xml version="1.0"?>\n<opencv_storage>\n'
        f"<rvec>{rtxt}</rvec>\n<tvec>{ttxt}</tvec>\n</opencv_storage>\n"
    )


def rvec_tvec_xml_filestorage(rvec, tvec) -> str:
    """MultiviewX style: FileStorage 3x1 matrices (`MultiviewX.py:87-92`)."""

    def mat(name, v):
        data = "\n    ".join(f"{x:.17g}" for x in v)
        return (
            f'<{name} type_id="opencv-matrix">\n  <rows>3</rows>\n  <cols>1</cols>\n'
            f"  <dt>d</dt>\n  <data>\n    {data}</data></{name}>\n"
        )

    return f'<?xml version="1.0"?>\n<opencv_storage>\n{mat("rvec", rvec)}{mat("tvec", tvec)}</opencv_storage>\n'


def rotation_to_rvec(R) -> np.ndarray:
    """Inverse Rodrigues (angle-axis from rotation matrix), incl. the
    angle~pi branch where the antisymmetric-part formula degenerates."""
    angle = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    if angle < 1e-9:
        return np.zeros(3)
    if np.pi - angle > 1e-6:
        axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / (2 * np.sin(angle))
    else:
        # near pi: R ~ 2*aa^T - I, so aa^T = (R + I)/2; magnitudes from the
        # diagonal, signs from the largest component's row
        A = (R + np.eye(3)) / 2
        axis = np.sqrt(np.clip(np.diag(A), 0, None))
        i = int(np.argmax(axis))
        for j in range(3):
            if j != i and axis[i] > 0:
                axis[j] = A[i, j] / axis[i]
        axis = axis / np.linalg.norm(axis)
    return axis * angle


def _write_annotations(root: str, scene) -> None:
    os.makedirs(os.path.join(root, "annotations_positions"), exist_ok=True)
    rig = scene.rig
    for frame in scene.frames():
        ann = scene.annotation(frame)
        people = []
        box_by_cam_pid = {
            (cam, int(pid)): box
            for cam in range(rig.num_cam)
            for pid, box in zip(ann.bbox_pids[cam], ann.bboxes[cam])
        }
        for pt, pid in zip(ann.world_pts, ann.pids):
            views = []
            for cam in range(rig.num_cam):
                box = box_by_cam_pid.get((cam, int(pid)))
                if box is None:
                    views.append({"viewNum": cam, "xmin": -1, "ymin": -1, "xmax": -1, "ymax": -1})
                else:
                    views.append({
                        "viewNum": cam,
                        "xmin": int(round(box[0])), "ymin": int(round(box[1])),
                        "xmax": int(round(box[2])), "ymax": int(round(box[3])),
                    })
            people.append({
                "personID": int(pid),
                "positionID": int(rig.pos_from_worldgrid(np.round(pt).astype(np.int64))),
                "views": views,
            })
        with open(os.path.join(root, "annotations_positions", f"{frame:08d}.json"), "w") as fh:
            json.dump(people, fh)


def image_path(root: str, cam: int, frame: int) -> str:
    """Where a tree keeps camera ``cam``'s (0-based) frame ``frame``."""
    return os.path.join(root, "Image_subsets", f"C{cam + 1}", f"{frame:08d}.png")


def _write_images(root: str, scene) -> None:
    for cam in range(scene.rig.num_cam):
        os.makedirs(os.path.join(root, "Image_subsets", f"C{cam + 1}"), exist_ok=True)
        for frame in scene.frames():
            write_png(image_path(root, cam, frame), scene.image(cam, frame))


def write_wildtrack_tree(root: str, scene, with_images: bool = True) -> None:
    rig = scene.rig
    assert rig.num_cam == 7, "Wildtrack format is 7-camera"
    os.makedirs(os.path.join(root, "calibrations", "intrinsic_zero"), exist_ok=True)
    os.makedirs(os.path.join(root, "calibrations", "extrinsic"), exist_ok=True)
    for cam in range(7):
        with open(os.path.join(root, "calibrations", "intrinsic_zero", _WILDTRACK_INTR[cam]), "w") as fh:
            fh.write(opencv_matrix_xml("camera_matrix", rig.intrinsic_matrices[cam]))
        R, t = rig.extrinsic_matrices[cam][:, :3], rig.extrinsic_matrices[cam][:, 3]
        with open(os.path.join(root, "calibrations", "extrinsic", _WILDTRACK_EXTR[cam]), "w") as fh:
            fh.write(rvec_tvec_xml_raw(rotation_to_rvec(R), t))
    _write_annotations(root, scene)
    if with_images:
        _write_images(root, scene)


def write_multiviewx_tree(root: str, scene, with_images: bool = True) -> None:
    rig = scene.rig
    assert rig.num_cam == 6, "MultiviewX format is 6-camera"
    os.makedirs(os.path.join(root, "calibrations", "intrinsic"), exist_ok=True)
    os.makedirs(os.path.join(root, "calibrations", "extrinsic"), exist_ok=True)
    for cam in range(6):
        with open(os.path.join(root, "calibrations", "intrinsic", _MULTIVIEWX_INTR[cam]), "w") as fh:
            fh.write(opencv_matrix_xml("camera_matrix", rig.intrinsic_matrices[cam]))
        R, t = rig.extrinsic_matrices[cam][:, :3], rig.extrinsic_matrices[cam][:, 3]
        with open(os.path.join(root, "calibrations", "extrinsic", _MULTIVIEWX_EXTR[cam]), "w") as fh:
            fh.write(rvec_tvec_xml_filestorage(rotation_to_rvec(R), t))
    _write_annotations(root, scene)
    if with_images:
        _write_images(root, scene)


def wildtrack_like_scene(num_frame: int = 10, num_person: int = 10, seed: int = 2021,
                         img_shape=(1080, 1920), cache_images: bool = True):
    """A SyntheticScene on a rig with full Wildtrack conventions (7 cams,
    480x1440 ij grid, centimeters, origin (-300, -900))."""
    rig = make_synthetic_rig(
        num_cam=7, img_shape=img_shape, worldgrid_shape=(480, 1440), cell_meters=0.025,
        indexing="ij", worldcoord_unit=0.01, origin_offset=(-300.0, -900.0),
        camera_height_m=6.0, camera_margin_m=4.0,
    )
    return SyntheticScene(rig, num_frame=num_frame, num_person=num_person, seed=seed,
                          cache_images=cache_images)


def multiviewx_like_scene(num_frame: int = 8, num_person: int = 8, seed: int = 2021,
                          img_shape=(1080, 1920)):
    """A SyntheticScene on a rig with MultiviewX conventions (6 cams,
    640x1000 xy grid, meters)."""
    rig = make_synthetic_rig(
        num_cam=6, img_shape=img_shape, worldgrid_shape=(640, 1000), cell_meters=0.025,
        indexing="xy", worldcoord_unit=1.0, origin_offset=(0.0, 0.0),
        camera_height_m=6.0, camera_margin_m=4.0,
    )
    return SyntheticScene(rig, num_frame=num_frame, num_person=num_person, seed=seed)
