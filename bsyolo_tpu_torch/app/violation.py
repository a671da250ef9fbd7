"""Parking-violation rules (counterpart of ``bsyolo_tpu/app/violation.py``; reference
sys/is_parking_violation.py, sys/videobytetrack.py:48-80, sys/VehicleTimer.py).
Host numpy on the host mask, as in the JAX package."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np


def occlusion_ratio(
    box_xyxy: Tuple[int, int, int, int],
    live_mask: np.ndarray,
    background_mask: np.ndarray,
) -> float:
    """1 - (blind-way pixels in box on the live mask / same on the background
    mask) — reference videobytetrack.py:68-78."""
    x1, y1, x2, y2 = (int(v) for v in box_xyxy)
    h, w = background_mask.shape[:2]
    x1, y1 = max(0, x1), max(0, y1)
    x2, y2 = min(w, x2), min(h, y2)
    if x2 <= x1 or y2 <= y1:
        return 0.0
    live = int(np.sum(live_mask[y1:y2, x1:x2] == 255))
    background = int(np.sum(background_mask[y1:y2, x1:x2] == 255))
    if background <= 0:
        return 0.0
    return 1.0 - live / background


def is_parking_violation(
    box_xywh,
    live_mask: np.ndarray,
    background_mask: np.ndarray,
    threshold: float = 0.7,
) -> Tuple[bool, Tuple[int, int, int, int]]:
    """Violation if the vehicle box occludes >= threshold of the tactile
    paving visible in the background (reference videobytetrack.py:48-80)."""
    cx, cy, bw, bh = box_xywh[:4]
    box = (int(cx - bw / 2), int(cy - bh / 2), int(cx + bw / 2), int(cy + bh / 2))
    return occlusion_ratio(box, live_mask, background_mask) >= threshold, box


def _iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


class VehicleTimer:
    """Per-track dwell timer (reference sys/VehicleTimer.py:34-83).

    Starts counting when a track is first flagged; resets if the vehicle
    moved (IoU with the initial box < iou_threshold); reports a violation
    once the elapsed time passes violation_threshold seconds.
    """

    def __init__(
        self,
        violation_threshold: float = 10.0,
        iou_threshold: float = 0.7,
        clock=time.time,
    ):
        self.violation_threshold = violation_threshold
        self.iou_threshold = iou_threshold
        self.clock = clock  # injectable for tests / video-time clocks
        self.timers: Dict[int, dict] = defaultdict(
            lambda: {"start_time": None, "initial_box": None, "current_box": None}
        )

    def update(self, track_id: int, current_box) -> Tuple[float, bool]:
        t = self.timers[track_id]
        if t["start_time"] is None:
            t["start_time"] = self.clock()
            t["initial_box"] = current_box
            t["current_box"] = current_box
        else:
            t["current_box"] = current_box
            if _iou(t["initial_box"], current_box) < self.iou_threshold:
                t["start_time"] = self.clock()
                t["initial_box"] = current_box
            elapsed = self.clock() - t["start_time"]
            if elapsed >= self.violation_threshold:
                return elapsed, True
        return 0.0, False

    def reset(self, track_id: int):
        self.timers[track_id] = {"start_time": None, "initial_box": None, "current_box": None}
