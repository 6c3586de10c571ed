"""CLEAR detection metrics (MODA / MODP / precision / recall), a copy of
``mvdetr_tpu/evaluation/clear.py`` (numpy + scipy, unchanged).

Behavioral port of the original MVDeTr's python evaluation path
(`multiview_detector/evaluation/pyeval/evaluateDetection.py`
and `pyeval/CLEAR_MOD_HUN.py`), vectorized:

- frames are enumerated from the *detection* file; ground-truth rows of frames
  with no detections are skipped (`evaluateDetection.py:54,65-94` quirk,
  preserved for score parity),
- per-frame Euclidean distance matrix, entries > td clamped to 1e6 before
  scipy's Hungarian assignment; matches accepted strictly below td
  (`CLEAR_MOD_HUN.py:59-76`),
- td = 50 / 2.5 = 20 grid cells = 0.5 m (`CLEAR_MOD_HUN.py:29`),
- MODA = (1 - (miss + fp) / gt) * 100, MODP = mean(1 - d/td) over TPs * 100,
  all clamped at >= 0 (`CLEAR_MOD_HUN.py:93-98`).
"""

from __future__ import annotations

import os

import numpy as np
from scipy.optimize import linear_sum_assignment


def clear_metrics(gt_rows: np.ndarray, det_rows: np.ndarray, td: float = 50.0 / 2.5):
    """``gt_rows``/``det_rows``: [*, 3] arrays of (frame, x, y).

    Returns (recall, precision, moda, modp) as percentages.
    """
    gt_rows = np.asarray(gt_rows, dtype=np.float64).reshape(-1, 3)
    det_rows = np.asarray(det_rows, dtype=np.float64).reshape(-1, 3)
    if det_rows.shape[0] == 0:
        return 0.0, 0.0, 0.0, 0.0

    frames = np.unique(det_rows[:, 0])
    total_c = total_fp = total_m = total_g = 0.0
    modp_sum = 0.0
    for t in frames:
        gt = gt_rows[gt_rows[:, 0] == t][:, 1:3]
        det = det_rows[det_rows[:, 0] == t][:, 1:3]
        n_gt, n_det = len(gt), len(det)
        total_g += n_gt
        c = 0
        if n_gt and n_det:
            dist = np.linalg.norm(gt[:, None, :] - det[None, :, :], axis=-1)
            cost = np.where(dist > td, 1e6, dist)
            if not np.all(cost == 1e6):
                rows, cols = linear_sum_assignment(cost)
                matched = dist[rows, cols] < td
                c = int(matched.sum())
                modp_sum += np.sum(1.0 - dist[rows, cols][matched] / td)
        total_c += c
        total_fp += n_det - c
        total_m += n_gt - c

    recall = total_c / total_g * 100 if total_g else 0.0
    precision = total_c / (total_fp + total_c) * 100 if (total_fp + total_c) else 0.0
    moda = (1.0 - (total_m + total_fp) / total_g) * 100 if total_g else 0.0
    modp = modp_sum / total_c * 100 if total_c else 0.0
    return max(recall, 0.0), max(precision, 0.0), max(moda, 0.0), max(modp, 0.0)


def evaluate_files(res_fpath: str, gt_fpath: str, td: float = 50.0 / 2.5):
    """File-based entry matching `evaluation/evaluate.py:21-33`'s signature."""
    gt = np.loadtxt(gt_fpath)
    det = np.loadtxt(res_fpath) if _nonempty(res_fpath) else np.zeros((0, 3))
    return clear_metrics(gt.reshape(-1, 3), det.reshape(-1, 3), td)


def _nonempty(path: str) -> bool:
    try:
        return os.path.getsize(path) > 0
    except OSError:
        return False
