"""Tracker wiring into the prediction stream (counterpart of ``bsyolo_tpu/trackers/track.py``;
reference trackers/track.py). Tracker YAMLs are read with the port's own
YAML reader (``cfg.read_yaml``).

The reference registers predictor callbacks; here `track_results` post-
processes each Results: run the tracker on its boxes, reorder by matched
detection index, and attach track IDs (reference track.py:53-88).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from bsyolo_tpu_torch.cfg import read_yaml
from bsyolo_tpu_torch.engine.results import Results
from bsyolo_tpu_torch.trackers.bot_sort import BOTSORT
from bsyolo_tpu_torch.trackers.byte_tracker import BYTETracker

TRACKER_CFG_DIR = Path(__file__).parent / "cfg"


def create_tracker(tracker: str = "bytetrack.yaml") -> BYTETracker:
    """Build a tracker from a tracker YAML name or path (reference track.py:18)."""
    path = Path(tracker)
    if not path.exists():
        path = TRACKER_CFG_DIR / path.name
    cfg = (read_yaml(path) or {}) if path.exists() else {}
    ttype = cfg.get("tracker_type", "bytetrack")
    if ttype not in ("bytetrack", "botsort"):
        raise ValueError(f"unsupported tracker_type: {ttype}")
    common = dict(
        track_high_thresh=cfg.get("track_high_thresh", 0.25),
        track_low_thresh=cfg.get("track_low_thresh", 0.1),
        new_track_thresh=cfg.get("new_track_thresh", 0.25),
        track_buffer=cfg.get("track_buffer", 30),
        match_thresh=cfg.get("match_thresh", 0.8),
        fuse_score=cfg.get("fuse_score", True),
    )
    if ttype == "botsort":
        return BOTSORT(
            proximity_thresh=cfg.get("proximity_thresh", 0.5),
            appearance_thresh=cfg.get("appearance_thresh", 0.25),
            with_reid=cfg.get("with_reid", False),
            gmc_method=cfg.get("gmc_method", "sparseOptFlow"),
            **common,
        )
    tracker = BYTETracker(**common)
    tracker.gmc = None
    return tracker


def track_results(tracker: BYTETracker, result: Results) -> Results:
    """Update tracker with one frame's detections; return re-indexed Results."""
    if result.boxes is None or len(result.boxes) == 0:
        tracker.update(
            np.zeros((0, 4), np.float32), np.zeros((0,)), np.zeros((0,)), img=result.orig_img
        )
        return result
    xywh = result.boxes.xywh
    tracks = tracker.update(xywh, result.boxes.conf, result.boxes.cls, img=result.orig_img)
    if len(tracks) == 0:
        return result.new(boxes=np.zeros((0, 7), np.float32))
    idx = tracks[:, -1].astype(int)
    data = result.boxes.data[idx]
    # columns: x1, y1, x2, y2, track_id, conf, cls (tracked layout)
    boxes = np.concatenate([tracks[:, :4], tracks[:, 4:5], data[:, 4:6]], axis=-1)
    return result.new(boxes=boxes)
