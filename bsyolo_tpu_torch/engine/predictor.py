"""Detection predictor (counterpart of ``bsyolo_tpu/engine/predictor.py``, detect branch).

Sources (numpy frames, lists of them, image files and directories) ->
letterbox on the model's device -> uint8 batches of ``batch`` frames (the
last one padded by repeating its last frame, so every batch has one shape)
-> /255, graph, fused decode and NMS on the device -> boxes scaled back to
each original frame -> ``Results``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from bsyolo_tpu_torch.engine.results import Results
from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess
from bsyolo_tpu_torch.ops.boxes import scale_boxes
from bsyolo_tpu_torch.ops.letterbox import letterbox

IMG_SUFFIXES = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}
VID_SUFFIXES = {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".mpg", ".mpeg", ".wmv", ".webm"}


def _imread(path) -> Optional[np.ndarray]:
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"reading the image file {path} needs OpenCV (cv2), which is not installed; "
            "pass decoded uint8 BGR numpy frames instead"
        ) from e
    return cv2.imread(str(path))


def iter_source(source) -> Iterator[tuple]:
    """Yield (uint8 BGR frame, path) from an array, a list, an image file or a directory."""
    if isinstance(source, np.ndarray):
        yield source, "array"
        return
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from iter_source(s)
        return
    p = Path(str(source))
    if p.is_dir():
        for f in sorted(p.rglob("*")):
            if f.suffix.lower() in IMG_SUFFIXES:
                im = _imread(f)
                if im is not None:
                    yield im, str(f)
        return
    s = str(source)
    if p.suffix.lower() in VID_SUFFIXES or s.endswith(".streams") or s.isnumeric() or "://" in s:
        raise NotImplementedError(f"video and stream sources ({s}) are not ported yet (ROADMAP queue 1, item 17)")
    im = _imread(p)
    if im is None:
        raise FileNotFoundError(f"cannot read source: {source}")
    yield im, s


class DetectionPredictor:
    def __init__(
        self,
        model: torch.nn.Module,
        spec,
        device: torch.device,
        conf: float = 0.25,
        iou: float = 0.7,
        max_det: int = 300,
        imgsz: int = 640,
        classes: Optional[List[int]] = None,
        agnostic_nms: bool = False,
        names: Optional[Dict[int, str]] = None,
        batch: int = 1,
    ):
        self.model = model
        self.spec = spec
        self.device = device
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.imgsz = imgsz
        self.classes = classes
        self.agnostic_nms = agnostic_nms
        self.names = names or {i: n for i, n in enumerate(spec.names)}
        self.batch = max(int(batch), 1)

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) uint8 RGB on the device -> (B, max_det, 6) detections on the device."""
        feats = self.model(x.float() / 255.0)
        return detect_postprocess(
            feats, self.spec.head_strides, self.spec.nc, conf_thres=self.conf, iou_thres=self.iou,
            max_det=self.max_det, agnostic=self.agnostic_nms, reg_max=self.spec.reg_max,
        )

    def _batches(self, source):
        frames, paths, lbs, t_pre = [], [], [], 0.0
        for frame, path in iter_source(source):
            t0 = time.perf_counter()
            lbs.append(letterbox(frame, (self.imgsz, self.imgsz), self.device))
            t_pre += time.perf_counter() - t0
            frames.append(frame)
            paths.append(path)
            if len(frames) == self.batch:
                yield frames, paths, torch.stack(lbs), t_pre
                frames, paths, lbs, t_pre = [], [], [], 0.0
        if frames:
            lbs += [lbs[-1]] * (self.batch - len(frames))
            yield frames, paths, torch.stack(lbs), t_pre

    def stream(self, source, verbose: bool = False) -> Iterator[Results]:
        for frames, paths, x, t_pre in self._batches(source):
            t1 = time.perf_counter()
            dets = self.forward(x).cpu().numpy()  # the copy waits for the device
            inf_ms = (time.perf_counter() - t1) * 1000 / len(frames)
            pre_ms = t_pre * 1000 / len(frames)
            for i, (frame, path) in enumerate(zip(frames, paths)):
                t2 = time.perf_counter()
                res = self._to_results(dets[i], frame, path)
                res.speed = {"preprocess": pre_ms, "inference": inf_ms, "postprocess": (time.perf_counter() - t2) * 1000}
                if verbose:
                    print(f"{path}: {res.verbose_line} ({inf_ms:.1f} ms)")
                yield res

    def _to_results(self, dets: np.ndarray, frame: np.ndarray, path: str) -> Results:
        d = dets[dets[:, 4] > 0]
        if self.classes is not None and len(d):
            d = d[np.isin(d[:, 5].astype(int), self.classes)]
        if len(d):
            boxes = scale_boxes((self.imgsz, self.imgsz), torch.from_numpy(d[:, :4]), frame.shape[:2]).numpy()
            d = np.concatenate([boxes, d[:, 4:6]], -1)
        else:
            d = np.zeros((0, 6), np.float32)
        return Results(frame, path, self.names, boxes=d)

    def __call__(self, source, **kwargs) -> List[Results]:
        return list(self.stream(source, **kwargs))
