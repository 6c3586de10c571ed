"""The port's dataset-tree writer (``mvdetr_tpu_torch/data/trees.py``) and
its PNG disk path against the JAX package:

- on a port-written PNG tree, the JAX package's adapters (decoding with cv2)
  and the port's (decoding with ``data/png.py``) give identical frames,
  rigs and annotations, and identical ``FrameDataset`` batches (the test
  split, and the train split without augmentation; with augmentation every
  key but ``imgs`` is identical and ``imgs`` hold ``test_torch_port_data``'s
  bound, the JAX package warping with cv2), for Wildtrack and MultiviewX;
- every decoded frame is the scene's own render, byte for byte;
- the calibration and annotation files are byte-identical to
  ``tests/_fixture_trees.py``'s for the same scene.
"""

import os

import numpy as np
import pytest

from _fixture_trees import multiviewx_like_scene as jax_multiviewx_scene
from _fixture_trees import wildtrack_like_scene as jax_wildtrack_scene
from _fixture_trees import write_multiviewx_tree as jax_write_multiviewx
from _fixture_trees import write_wildtrack_tree as jax_write_wildtrack
from mvdetr_tpu.data import FrameDataset as JaxFrameDataset
from mvdetr_tpu.data.adapters import MultiviewXScene as JaxMultiviewX
from mvdetr_tpu.data.adapters import WildtrackScene as JaxWildtrack
from mvdetr_tpu_torch.data import FrameDataset, MultiviewXScene, WildtrackScene
from mvdetr_tpu_torch.data.trees import (
    image_path, multiviewx_like_scene, wildtrack_like_scene, write_multiviewx_tree, write_wildtrack_tree,
)

from _torch_port import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

# Wildtrack at its full 1080x1920 frames; MultiviewX's frames smaller (the adapters read any size)
TREES = {
    "wildtrack": (wildtrack_like_scene, write_wildtrack_tree, WildtrackScene, JaxWildtrack,
                  dict(num_frame=3, num_person=8)),
    "multiviewx": (multiviewx_like_scene, write_multiviewx_tree, MultiviewXScene, JaxMultiviewX,
                   dict(num_frame=3, num_person=8, img_shape=(216, 384))),
}
DS = dict(world_reduce=4, img_reduce=24, top_k=16, world_kernel_size=4, img_kernel_size=4, seed=3)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Each format's scene and the root of its PNG tree."""
    out = {}
    for name, (make_scene, write, *_, kw) in TREES.items():
        root = str(tmp_path_factory.mktemp("trees") / name.capitalize())
        scene = make_scene(**kw)
        write(root, scene)
        out[name] = (scene, root)
    return out


def _flat(batch):
    for key, value in batch.items():
        if isinstance(value, dict):
            yield from ((f"{key}.{k}", v) for k, v in value.items())
        else:
            yield key, value


@pytest.mark.parametrize("name", sorted(TREES))
def test_png_tree_reads_the_same_through_both_packages(trees, name):
    scene, root = trees[name]
    port_cls, jax_cls = TREES[name][2:4]
    ours, theirs = port_cls(root), jax_cls(root)
    for attr in ("name", "num_cam", "img_shape", "worldgrid_shape", "indexing", "worldcoord_unit"):
        assert getattr(ours.rig, attr) == getattr(theirs.rig, attr), attr
    for attr in ("intrinsic_matrices", "extrinsic_matrices", "worldcoord_from_worldgrid_mat"):
        np.testing.assert_array_equal(getattr(ours.rig, attr), getattr(theirs.rig, attr))
    assert ours.frames() == theirs.frames() == scene.frames()
    for frame in ours.frames():
        a, b = theirs.annotation(frame), ours.annotation(frame)
        np.testing.assert_array_equal(a.world_pts, b.world_pts)
        np.testing.assert_array_equal(a.pids, b.pids)
        for cam in range(ours.rig.num_cam):
            np.testing.assert_array_equal(a.bboxes[cam], b.bboxes[cam])
            np.testing.assert_array_equal(a.bbox_pids[cam], b.bbox_pids[cam])
            assert ours._images[cam][frame] == image_path(root, cam, frame)
            img = ours.image(cam, frame)
            assert img.dtype == np.uint8 and img.shape == scene.image(cam, frame).shape
            assert np.array_equal(img, theirs.image(cam, frame)), (cam, frame)
            assert np.array_equal(img, scene.image(cam, frame)), (cam, frame)


@pytest.mark.parametrize("name", sorted(TREES))
def test_png_tree_batches_match_jax(trees, name):
    _, root = trees[name]
    port_cls, jax_cls = TREES[name][2:4]
    ours, theirs = port_cls(root), jax_cls(root)
    for kw in (dict(train=False), dict(train=True, augmentation=False), dict(train=True, augmentation=True)):
        jax_batches = list(JaxFrameDataset(theirs, **kw, **DS).batches(2, num_workers=2))
        batches = list(FrameDataset(ours, **kw, **DS).batches(2, num_workers=2))
        assert len(batches) == len(jax_batches) == 1
        for (key, a), (_, b) in zip(_flat(batches[0]), _flat(jax_batches[0])):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            if key == "imgs" and kw.get("augmentation"):  # cv2.warpPerspective in JAX, the native warp here
                assert np.quantile(np.abs(a.astype(int) - b.astype(int)), 0.99) <= 2, (kw, key)
            else:
                assert a.tobytes() == b.tobytes(), (kw, key)


@pytest.mark.parametrize("name", sorted(TREES))
def test_calibration_and_annotation_files_are_the_fixture_writers_bytes(tmp_path, name):
    make_scene, write, *_, kw = TREES[name]
    jax_make = {"wildtrack": jax_wildtrack_scene, "multiviewx": jax_multiviewx_scene}[name]
    jax_write = {"wildtrack": jax_write_wildtrack, "multiviewx": jax_write_multiviewx}[name]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    write(str(ours), make_scene(**kw), with_images=False)
    jax_write(str(theirs), jax_make(**kw), with_images=False)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    assert files(ours) == files(theirs) and len(files(ours)) == 2 * TREES[name][0](**kw).rig.num_cam + kw["num_frame"]
    for rel in files(ours):
        assert (ours / rel).read_bytes() == (theirs / rel).read_bytes(), rel
