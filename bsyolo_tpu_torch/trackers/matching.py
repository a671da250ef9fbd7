"""Association costs and Hungarian assignment (counterpart of ``bsyolo_tpu/trackers/matching.py``;
reference trackers/utils/matching.py). Host numpy and scipy."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.optimize

from bsyolo_tpu_torch.utils.metrics import _box_iou_np


def linear_assignment(cost_matrix: np.ndarray, thresh: float) -> Tuple[np.ndarray, tuple, tuple]:
    """Hungarian matching with a cost gate (reference matching.py:20-62)."""
    if cost_matrix.size == 0:
        return (
            np.empty((0, 2), dtype=int),
            tuple(range(cost_matrix.shape[0])),
            tuple(range(cost_matrix.shape[1])),
        )
    row, col = scipy.optimize.linear_sum_assignment(cost_matrix)
    ok = cost_matrix[row, col] <= thresh
    matches = np.stack([row[ok], col[ok]], axis=1) if ok.any() else np.empty((0, 2), dtype=int)
    unmatched_a = tuple(set(range(cost_matrix.shape[0])) - set(matches[:, 0]))
    unmatched_b = tuple(set(range(cost_matrix.shape[1])) - set(matches[:, 1]))
    return matches, unmatched_a, unmatched_b


def iou_distance(atracks: List, btracks: List) -> np.ndarray:
    """1 - IoU cost between track xyxy boxes (reference matching.py:64-102)."""
    if len(atracks) == 0 or len(btracks) == 0:
        return np.zeros((len(atracks), len(btracks)), dtype=np.float32)
    aboxes = np.asarray([t.xyxy for t in atracks], np.float32)
    bboxes = np.asarray([t.xyxy for t in btracks], np.float32)
    return 1.0 - _box_iou_np(aboxes, bboxes).astype(np.float32)


def fuse_score(cost_matrix: np.ndarray, detections: List) -> np.ndarray:
    """Fuse detection confidence into the IoU cost (reference matching.py:134)."""
    if cost_matrix.size == 0:
        return cost_matrix
    iou_sim = 1.0 - cost_matrix
    det_scores = np.asarray([d.score for d in detections])
    fuse_sim = iou_sim * det_scores[None, :]
    return 1.0 - fuse_sim


def embedding_distance(tracks: List, detections: List, metric: str = "cosine") -> np.ndarray:
    """Appearance cost between track smooth features and detection features
    (reference trackers/utils/matching.py:104)."""
    cost = np.zeros((len(tracks), len(detections)), dtype=np.float32)
    if cost.size == 0:
        return cost
    det = np.asarray([d.curr_feat for d in detections], dtype=np.float32)
    trk = np.asarray([t.smooth_feat for t in tracks], dtype=np.float32)
    if metric == "cosine":
        # features are L2-normalized; cosine distance = 1 - dot
        cost = 1.0 - trk @ det.T
    else:
        from scipy.spatial.distance import cdist

        cost = cdist(trk, det, metric).astype(np.float32)
    return np.maximum(0.0, cost)
