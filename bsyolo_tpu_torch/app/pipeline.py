"""The blind-sidewalk illegal-parking video pipeline (counterpart of ``bsyolo_tpu/app/pipeline.py``;
reference sys/videobytetrack.py:83-367).

Offline: extract and segment the static background. Online, per frame
(``process_frame``), two steps:

- ``decide``: YOLO + tracker vehicle detection (``YOLO.track``, on the
  detector's device) -> one live GRFB-UNet mask of the frame, triggered by
  the first detection (on the segmenter's device) -> per-box occlusion-ratio
  violation check -> per-track dwell timer -> the frame's event. No OpenCV.
- ``render``: boxes, labels and track trails drawn on a copy of the frame,
  the violation frames written as JPEG, the annotated frame handed to the
  video writer. OpenCV, imported here (without it: ImportError naming the
  ROADMAP item).

``run`` reads and writes video with OpenCV.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from bsyolo_tpu_torch.app.background import extract_static_background
from bsyolo_tpu_torch.app.grfb_unet import BlindwaySegmenter
from bsyolo_tpu_torch.app.violation import VehicleTimer, is_parking_violation
from bsyolo_tpu_torch.data.imread import imread
from bsyolo_tpu_torch.utils import CV2_DRAWING, CV2_VIDEO, LOGGER, import_cv2


class Mark(NamedTuple):
    """What ``render`` draws for one tracked row of a frame."""

    box: Tuple[int, int, int, int]
    tid: Optional[int]
    cls: int
    conf: float
    violating: bool
    long_violation: bool
    center: Tuple[int, int]


class ParkingViolationPipeline:
    def __init__(
        self,
        detector,  # bsyolo_tpu_torch.YOLO
        segmenter: BlindwaySegmenter,
        background: Optional[np.ndarray] = None,
        background_mask: Optional[np.ndarray] = None,
        occlusion_threshold: float = 0.7,
        dwell_seconds: float = 10.0,
        conf: float = 0.25,
        tracker: str = "bytetrack.yaml",
        clock=None,
    ):
        self.detector = detector
        self.segmenter = segmenter
        self.background = background
        self.background_mask = background_mask
        self.occlusion_threshold = occlusion_threshold
        self.conf = conf
        self.tracker = tracker
        kw = {"clock": clock} if clock else {}
        self.timer = VehicleTimer(violation_threshold=dwell_seconds, **kw)
        self.track_history: Dict[int, List] = defaultdict(list)

    def prepare_background(self, source) -> np.ndarray:
        """Build the background mask from a background image (an array or a file) or a video."""
        if isinstance(source, np.ndarray):
            self.background = source
        elif str(source).lower().endswith((".mp4", ".avi", ".mov", ".mkv")):
            self.background = extract_static_background(source)
        else:
            self.background = imread(source)
        if self.background is None:
            raise ValueError(f"could not obtain background from {source}")
        self.background_mask = self.segmenter(self.background)
        return self.background_mask

    def run(self, video_path: str, output_dir: str = "results", save_video: bool = True):
        """Process a video; returns the list of per-frame event dicts."""
        cv2 = import_cv2("ParkingViolationPipeline.run (video in and out)", CV2_VIDEO)
        if self.background_mask is None:
            raise RuntimeError("call prepare_background() first")
        out_dir = Path(output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            raise FileNotFoundError(video_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 30
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        writer = None
        if save_video:
            writer = cv2.VideoWriter(str(out_dir / "output.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        events = []
        frame_idx = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                events.append(self.process_frame(frame, frame_idx, out_dir, writer))
                frame_idx += 1
        finally:
            cap.release()
            if writer is not None:
                writer.release()
        LOGGER.info(f"processed {frame_idx} frames -> {out_dir}")
        return events

    def process_frame(self, frame: np.ndarray, frame_idx: int = 0, out_dir: Optional[Path] = None, writer=None):
        """One online step; returns {frame, violations: [...], tracks: [...], annotated}."""
        event, marks = self.decide(frame, frame_idx)
        event["annotated"] = self.render(frame, frame_idx, event, marks, out_dir, writer)
        return event

    def decide(self, frame: np.ndarray, frame_idx: int = 0) -> Tuple[dict, List[Mark]]:
        """The decision step of ``process_frame``: track, the frame's one live segmentation (triggered by
        the first detection, reference videobytetrack.py:289-293), the occlusion rule and the dwell timer.
        Returns the event {frame, violations, tracks} and a ``Mark`` per tracked row for ``render``."""
        result = self.detector.track(frame, persist=True, conf=self.conf, tracker=self.tracker)[0]
        event = {"frame": frame_idx, "violations": [], "tracks": []}
        marks: List[Mark] = []
        if result.boxes is None or not len(result.boxes):
            return event, marks
        live_mask = self.segmenter(frame)
        for row in result.boxes.data:
            x1, y1, x2, y2 = row[:4]
            tid = int(row[4]) if result.boxes.is_track else None
            conf, cls = float(row[-2]), int(row[-1])
            xywh = ((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1)
            violating, box = is_parking_violation(xywh, live_mask, self.background_mask, self.occlusion_threshold)
            long_violation, elapsed = False, 0.0
            if violating and tid is not None:
                elapsed, long_violation = self.timer.update(tid, box)
            elif tid is not None:
                self.timer.reset(tid)
            marks.append(Mark(box, tid, cls, conf, violating, long_violation, (int(xywh[0]), int(xywh[1]))))
            event["tracks"].append({"id": tid, "box": box, "cls": cls, "conf": conf})
            if violating:
                event["violations"].append({"id": tid, "box": box, "long": long_violation, "elapsed": elapsed})
        return event, marks

    def render(self, frame: np.ndarray, frame_idx: int, event: dict, marks: List[Mark],
               out_dir: Optional[Path] = None, writer=None) -> np.ndarray:
        """The rendering step of ``process_frame``: the annotated copy of ``frame`` (a box, a label and a
        track trail per mark); with ``out_dir``, the frame of each long violation and the annotated
        frame of a frame with violations written as JPEG; the annotated frame handed to ``writer``."""
        annotated = frame.copy()
        if marks:
            cv2 = import_cv2("ParkingViolationPipeline.render (drawing)", CV2_DRAWING)
        for m in marks:
            if m.long_violation and out_dir is not None:
                cv2.imwrite(str(out_dir / f"longtimeviolation_car_{m.tid}.jpg"), frame)
            color = (0, 0, 255) if m.violating else (0, 255, 0)
            cv2.rectangle(annotated, m.box[:2], m.box[2:], color, 2)
            label = f"ID: {m.tid}" if m.tid is not None else "ID: None"
            label += f" {self.detector.names.get(m.cls, m.cls)} Conf: {m.conf:.2f}"
            cv2.putText(annotated, label, (m.box[0], max(m.box[1] - 10, 12)), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 2)
            if m.tid is not None:
                track = self.track_history[m.tid]
                track.append(m.center)
                if len(track) > 20:
                    track.pop(0)
                pts = np.asarray(track, np.int32).reshape(-1, 1, 2)
                cv2.polylines(annotated, [pts], isClosed=False, color=(0, 255, 255), thickness=2)
        if event["violations"] and out_dir is not None:
            cv2.imwrite(str(out_dir / f"violation_frame_{frame_idx}.jpg"), annotated)
        if writer is not None:
            writer.write(annotated)
        return annotated
