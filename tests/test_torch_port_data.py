"""The port's data path against the JAX package's, on one ``SyntheticScene``
seed, with augmentation, camera dropout and the semi-supervised keep flags on:

- the frames, the batch order, the per-item seeds (the datasets' generator
  states after an epoch), the augmentation matrices, every target, the
  dropped cameras, the keep flags and ``gt_array`` are exactly equal;
- the images are within q99 <= 2 levels of the JAX package's with cv2 (its
  ``cv2.warpPerspective``; the resize is cv2's to the byte, and the test
  split, which is not augmented, is byte-identical);
- the port's batches are byte-identical with cv2 hidden and without it: the
  port computes one thing on every machine;
- the scene's annotations and rendered images are equal;
- the adapters read the same rig and annotations from the on-disk fixture
  trees as the JAX package's, and the image decode raises without cv2 and PIL;
- ``prefetch_to_device`` on the CPU passes batches through and re-raises an
  error of the iterator.
"""

import sys

import numpy as np
import pytest

from _fixture_trees import multiviewx_like_scene, wildtrack_like_scene, write_multiviewx_tree, write_wildtrack_tree
from mvdetr_tpu.data import FrameDataset as JaxFrameDataset
from mvdetr_tpu.data import SyntheticScene as JaxScene
from mvdetr_tpu.data.adapters import MultiviewXScene as JaxMultiviewX
from mvdetr_tpu.data.adapters import WildtrackScene as JaxWildtrack
from mvdetr_tpu.geometry import make_synthetic_rig as jax_rig
from mvdetr_tpu_torch.data import FrameDataset, SyntheticScene, prefetch_to_device
from mvdetr_tpu_torch.data.adapters import MultiviewXScene, WildtrackScene, load_image_rgb
from mvdetr_tpu_torch.geometry import make_synthetic_rig

from _torch_port import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RIG = dict(num_cam=3, img_shape=(96, 160), worldgrid_shape=(48, 96), indexing="ij", worldcoord_unit=0.01,
           origin_offset=(-60.0, -120.0))
SCENE = dict(num_frame=12, num_person=6, seed=7)
DS = dict(world_reduce=2, img_reduce=12, top_k=16, world_kernel_size=4, img_kernel_size=4, seed=11)
TRAIN = dict(train=True, augmentation=True, dropout=0.5, semi_supervised=0.6)


def _datasets(train_kw):
    jax_scene, scene = JaxScene(jax_rig(**RIG), **SCENE), SyntheticScene(make_synthetic_rig(**RIG), **SCENE)
    return JaxFrameDataset(jax_scene, **train_kw, **DS), FrameDataset(scene, **train_kw, **DS)


def _epoch(ds, batch_size=2, num_workers=2):
    return list(ds.batches(batch_size, num_workers=num_workers))


def _flat(batch):
    for key, value in batch.items():
        if isinstance(value, dict):
            for k, v in value.items():
                yield f"{key}.{k}", v
        else:
            yield key, value


def test_scene_annotations_and_images_equal():
    jax_scene, scene = JaxScene(jax_rig(**RIG), **SCENE), SyntheticScene(make_synthetic_rig(**RIG), **SCENE)
    assert jax_scene.frames() == scene.frames()
    for frame in (0, 5, 11):
        a, b = jax_scene.annotation(frame), scene.annotation(frame)
        np.testing.assert_array_equal(a.world_pts, b.world_pts)
        np.testing.assert_array_equal(a.pids, b.pids)
        for cam in range(3):
            np.testing.assert_array_equal(a.bboxes[cam], b.bboxes[cam])
            np.testing.assert_array_equal(a.bbox_pids[cam], b.bbox_pids[cam])
            np.testing.assert_array_equal(jax_scene.image(cam, frame), scene.image(cam, frame))


def test_train_split_matches_jax():
    jax_ds, ds = _datasets(TRAIN)
    assert jax_ds.frames == ds.frames and jax_ds.keeps == ds.keeps
    assert not all(ds.keeps.values()) and any(ds.keeps.values())
    assert ds.input_shape == jax_ds.input_shape and ds.Rimg_shape == jax_ds.Rimg_shape
    assert ds.steps_per_epoch(2) == jax_ds.steps_per_epoch(2)
    jax_batches, batches = _epoch(jax_ds), _epoch(ds)
    assert len(batches) == len(jax_batches) == 5
    # the per-item seeds are drawn from the dataset's generator: equal states after an epoch
    assert ds._rng.bit_generator.state == jax_ds._rng.bit_generator.state
    dropped = 0
    for jb, b in zip(jax_batches, batches):
        jflat, flat = dict(_flat(jb)), dict(_flat(b))
        assert jflat.keys() == flat.keys()
        for key in flat:
            if key == "imgs":
                continue
            assert flat[key].dtype == jflat[key].dtype, key
            np.testing.assert_array_equal(flat[key], jflat[key], err_msg=key)
        assert not np.allclose(b["affine_mats"], np.eye(3))
        assert b["imgs"].dtype == np.uint8 and b["imgs"].shape == jb["imgs"].shape
        diff = np.abs(b["imgs"].astype(int) - jb["imgs"].astype(int))
        assert np.quantile(diff, 0.99) <= 2, np.quantile(diff, 0.99)
        # a dropped camera: no valid target in one view of a frame set whose other views have some
        valid = b["imgs_gt"]["reg_mask"].any(-1)
        dropped += int((~valid & valid.any(-1, keepdims=True)).sum())
    assert dropped > 0


def test_test_split_is_byte_identical_to_jax():
    jax_ds, ds = _datasets(dict(train=False))
    for jb, b in zip(_epoch(jax_ds, 1, 0), _epoch(ds, 1, 0)):
        for (key, a), (_, r) in zip(_flat(b), _flat(jb)):
            np.testing.assert_array_equal(a, r, err_msg=key)
    np.testing.assert_array_equal(ds.gt_array(), jax_ds.gt_array())
    assert len(ds.gt_array()) > 0


def test_batches_are_the_same_bytes_without_cv2(monkeypatch):
    with_cv2 = _epoch(_datasets(TRAIN)[1])
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` now raises ImportError
    with pytest.raises(ImportError):
        import cv2  # noqa: F401
    without = _epoch(_datasets(TRAIN)[1], num_workers=0)
    for a, b in zip(with_cv2, without):
        for (key, x), (_, y) in zip(_flat(a), _flat(b)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), key


@pytest.fixture(scope="module")
def fixture_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    wild, mvx = root / "Wildtrack", root / "MultiviewX"
    write_wildtrack_tree(str(wild), wildtrack_like_scene(num_frame=3, num_person=6, img_shape=(108, 192)))
    write_multiviewx_tree(str(mvx), multiviewx_like_scene(num_frame=3, num_person=6, img_shape=(108, 192)))
    return str(wild), str(mvx)


@pytest.mark.parametrize("which", [0, 1])
def test_adapters_match_jax(fixture_trees, which):
    root = fixture_trees[which]
    jax_scene, scene = (JaxWildtrack(root), WildtrackScene(root)) if which == 0 else (JaxMultiviewX(root),
                                                                                       MultiviewXScene(root))
    for name in ("name", "num_cam", "img_shape", "worldgrid_shape", "indexing", "worldcoord_unit"):
        assert getattr(scene.rig, name) == getattr(jax_scene.rig, name), name
    for name in ("intrinsic_matrices", "extrinsic_matrices", "worldcoord_from_worldgrid_mat"):
        np.testing.assert_array_equal(getattr(scene.rig, name), getattr(jax_scene.rig, name))
    assert scene.frames() == jax_scene.frames() == [0, 1, 2]
    for frame in scene.frames():
        a, b = jax_scene.annotation(frame), scene.annotation(frame)
        np.testing.assert_array_equal(a.world_pts, b.world_pts)
        np.testing.assert_array_equal(a.pids, b.pids)
        for cam in range(scene.rig.num_cam):
            np.testing.assert_array_equal(a.bboxes[cam], b.bboxes[cam])
            np.testing.assert_array_equal(a.bbox_pids[cam], b.bbox_pids[cam])
    np.testing.assert_array_equal(scene.image(1, 2), jax_scene.image(1, 2))


def test_image_decode_without_cv2_and_without_either(fixture_trees, monkeypatch):
    path = WildtrackScene(fixture_trees[0])._images[0][0]
    with_cv2 = load_image_rgb(path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with_pil = load_image_rgb(path)  # another JPEG decoder: close, not equal
    assert with_pil.shape == with_cv2.shape and with_pil.dtype == np.uint8
    assert np.quantile(np.abs(with_pil.astype(int) - with_cv2.astype(int)), 0.99) <= 8
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="needs cv2 or PIL"):
        load_image_rgb(path)


def test_prefetch_on_the_cpu_passes_through_and_reraises():
    items = [{"imgs": np.full((2, 3), i), "frame": np.array([i])} for i in range(3)]
    out = list(prefetch_to_device(iter(items), "cpu"))
    assert all(a is b for a, b in zip(out, items))

    def failing():
        yield items[0]
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for item in prefetch_to_device(failing(), "cpu"):
            got.append(item)
    assert got == [items[0]]
