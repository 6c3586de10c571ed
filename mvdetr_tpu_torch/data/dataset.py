"""Frame dataset — host-side pipeline producing fixed-shape batches, port of
``mvdetr_tpu/data/dataset.py``.

Behavioral contract from the original MVDeTr's
``multiview_detector/datasets/frameDataset.py:49-239``:

- 90/10 frame split (`:73-76`),
- input resize to ``img_shape * 8 / img_reduce`` (`:66-67`); reduced shapes
  ``Rworld = grid / world_reduce``, ``Rimg = ceil(img / img_reduce)``
  (`:70-71`),
- per-view GT at the augmented foot point ``((x1+x2)/2, y2)`` with box sizes
  (`:207-211`), world GT from native-grid positions (`:232-235`),
- per-view ``random_affine`` returning the matrix M for the model (`:201-204`),
- camera dropout zeroes that camera's GT (not its pixels) (`:226-231`),
- semi-supervised keep fraction blanks annotations of late frames (`:94-99`),
- MOT-format ground-truth rows (frame, x, y) for CLEAR evaluation (`:155-175`).

Images stay uint8 (the model normalizes on the card, as the JAX package's
default ``device_normalize=True`` does). The frame split, the shuffle, the
per-item seeds, the augmentation draws and the targets are the JAX
package's, draw for draw. The resize is
:func:`mvdetr_tpu_torch.native.resize_u8`, the same bytes as the
``cv2.resize(INTER_LINEAR)`` that the JAX package calls, on every machine
and with no cv2 installed. The multi-host ``local_slice`` waits for the
multi-GPU slice.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from mvdetr_tpu_torch import native
from mvdetr_tpu_torch.data.augment import random_affine
from mvdetr_tpu_torch.data.targets import build_targets


class FrameDataset:
    def __init__(
        self,
        source,
        train: bool = True,
        world_reduce: int = 4,
        img_reduce: int = 12,
        world_kernel_size: float = 10.0,
        img_kernel_size: float = 10.0,
        train_ratio: float = 0.9,
        top_k: int = 100,
        semi_supervised: float = 0.0,
        dropout: float = 0.0,
        augmentation: bool = False,
        seed: int = 2021,
    ):
        self.source = source
        self.rig = source.rig
        self.train = train
        self.world_reduce, self.img_reduce = world_reduce, img_reduce
        self.world_kernel_size, self.img_kernel_size = world_kernel_size, img_kernel_size
        self.top_k = top_k
        self.semi_supervised = semi_supervised * train
        self.dropout = dropout
        self.augmentation = augmentation
        self._rng = np.random.default_rng(seed)

        img_h, img_w = self.rig.img_shape
        self.input_shape = (img_h * 8 // img_reduce, img_w * 8 // img_reduce)
        self.Rimg_shape = (math.ceil(img_h / img_reduce), math.ceil(img_w / img_reduce))
        self.Rworld_shape = self.rig.Rworld_shape(world_reduce)

        all_frames = source.frames()
        split = int(len(all_frames) * train_ratio)
        self.frames = all_frames[:split] if train else all_frames[split:]
        # semi-supervised keep flags over the *train* range (`frameDataset.py:94`)
        self.keeps = {}
        for frame in self.frames:
            if self.semi_supervised:
                frac_before = np.mean(np.asarray(self.frames) < frame)
                self.keeps[frame] = bool(frac_before < self.semi_supervised)
            else:
                self.keeps[frame] = True

    def __len__(self):
        return len(self.frames)

    # ------------------------------------------------------------------ item
    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or self._rng
        frame = self.frames[index]
        ann = self.source.annotation(frame)
        keep = self.keeps[frame]
        n = self.rig.num_cam

        imgs, affine_mats, imgs_gt = [], [], []
        for cam in range(n):
            img = self.source.image(cam, frame)
            bboxes = ann.bboxes[cam] if keep else np.zeros((0, 4))
            pids = ann.bbox_pids[cam] if keep else np.zeros((0,), dtype=np.int64)
            if self.augmentation:
                img, bboxes, pids, M = random_affine(img, bboxes, pids, rng)
            else:
                M = np.eye(3)
            imgs.append(native.resize_u8(img, self.input_shape))
            affine_mats.append(M.astype(np.float32))

            if len(bboxes):
                foot_x = (bboxes[:, 0] + bboxes[:, 2]) / 2
                foot_y = bboxes[:, 3]
                w_s = bboxes[:, 2] - bboxes[:, 0]
                h_s = bboxes[:, 3] - bboxes[:, 1]
            else:
                foot_x = foot_y = w_s = h_s = np.zeros((0,))
                pids = np.zeros((0,), dtype=np.int64)
            imgs_gt.append(
                build_targets(
                    self.Rimg_shape, foot_x, foot_y, w_s, h_s, pids,
                    reduce=self.img_reduce, top_k=self.top_k, kernel_size=self.img_kernel_size,
                )
            )

        imgs_gt = {k: np.stack([g[k] for g in imgs_gt]) for k in imgs_gt[0]}

        # camera dropout: zero the dropped camera's GT (`frameDataset.py:226-231`)
        if self.dropout and rng.random() < self.dropout:
            drop_cam = int(rng.integers(0, n))
            for k in imgs_gt:
                imgs_gt[k][drop_cam] = 0

        world_pts = ann.world_pts if keep else np.zeros((0, 2))
        world_pids = ann.pids if keep else np.zeros((0,), dtype=np.int64)
        # Annotations carry dataset-native (grid_x, grid_y); the BEV targets
        # are built on the xy-indexed model grid (x = column, y = row). On ij
        # rigs (Wildtrack) native x spans the rows, so swap to (grid_y, grid_x)
        # before splatting (`frameDataset.py:108-111`).
        if len(world_pts) and self.rig.indexing == "ij":
            world_pts = world_pts[:, ::-1]
        world_gt = build_targets(
            self.Rworld_shape,
            world_pts[:, 0] if len(world_pts) else np.zeros((0,)),
            world_pts[:, 1] if len(world_pts) else np.zeros((0,)),
            pids=world_pids,
            reduce=self.world_reduce,
            top_k=self.top_k,
            kernel_size=self.world_kernel_size,
        )

        return {
            "imgs": np.stack(imgs),
            "affine_mats": np.stack(affine_mats),
            "world_gt": world_gt,
            "imgs_gt": imgs_gt,
            "frame": np.int64(frame),
        }

    # ------------------------------------------------------------------ eval
    def gt_array(self) -> np.ndarray:
        """MOT rows (frame, grid_x, grid_y) over this split (`frameDataset.py:155-175`)."""
        rows = []
        for frame in self.frames:
            ann = self.source.annotation(frame)
            for j in range(len(ann.pids)):
                visible = any(
                    len(ann.bbox_pids[cam]) and (ann.bbox_pids[cam] == ann.pids[j]).any()
                    for cam in range(self.rig.num_cam)
                )
                if visible:
                    rows.append([frame, ann.world_pts[j, 0], ann.world_pts[j, 1]])
        return np.asarray(rows, dtype=np.float64).reshape(-1, 3)

    # --------------------------------------------------------------- batching
    def batches(
        self,
        batch_size: int,
        shuffle: Optional[bool] = None,
        rng: Optional[np.random.Generator] = None,
        num_workers: int = 0,
        drop_last: Optional[bool] = None,
        local_slice: Optional[slice] = None,
    ) -> Iterator[dict]:
        """Yield collated batches. ``drop_last`` defaults to True in training
        so every step sees a full batch. Per-item augmentation seeds are drawn
        for the whole order first, so ``num_workers`` threads give the same
        batches as none.

        ``local_slice``: the rows of each global batch that this process
        assembles (:func:`mvdetr_tpu_torch.parallel.process_batch_slice`);
        the order and the seeds are drawn for the global batches, so every
        process sees the same stream whatever its slice."""
        shuffle = self.train if shuffle is None else shuffle
        drop_last = self.train if drop_last is None else drop_last
        rng = rng or self._rng
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        if drop_last:
            order = order[: len(order) - len(order) % batch_size] if len(order) >= batch_size else order
        seeds = rng.integers(2**31, size=len(order))
        sel = local_slice if local_slice is not None else slice(None)

        def fetch(args):
            i, seed = args
            return self.__getitem__(int(i), rng=np.random.default_rng(int(seed)))

        chunks = []
        for start in range(0, len(order), batch_size):
            idxs = order[start : start + batch_size]
            if len(idxs) < batch_size and drop_last:
                continue
            chunks.append(list(zip(idxs[sel], seeds[start : start + batch_size][sel])))

        if num_workers > 0:
            # one-batch lookahead keeps memory bounded while hiding item latency
            with ThreadPoolExecutor(num_workers) as pool:
                futs = [pool.submit(fetch, pair) for pair in chunks[0]] if chunks else []
                for ci in range(len(chunks)):
                    cur = futs
                    futs = [pool.submit(fetch, pair) for pair in chunks[ci + 1]] if ci + 1 < len(chunks) else []
                    yield collate([f.result() for f in cur])
        else:
            for chunk in chunks:
                yield collate([fetch(pair) for pair in chunk])

    def steps_per_epoch(self, batch_size: int) -> int:
        n = len(self)
        return n // batch_size if self.train else math.ceil(n / batch_size)


def collate(samples) -> dict:
    return {
        "imgs": np.stack([s["imgs"] for s in samples]),
        "affine_mats": np.stack([s["affine_mats"] for s in samples]),
        "frame": np.stack([s["frame"] for s in samples]),
        "world_gt": {k: np.stack([s["world_gt"][k] for s in samples]) for k in samples[0]["world_gt"]},
        "imgs_gt": {k: np.stack([s["imgs_gt"][k] for s in samples]) for k in samples[0]["imgs_gt"]},
    }
