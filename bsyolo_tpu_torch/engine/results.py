"""Results API, detect subset (counterpart of ``bsyolo_tpu/engine/results.py``).

Host numpy containers: by the time results exist, the device work is done.
Drawing and saving need OpenCV, which is imported only when they are called.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np


class Boxes:
    """Detection boxes; ``data`` is (n, 6): x1, y1, x2, y2, conf, cls."""

    def __init__(self, data: np.ndarray, orig_shape):
        if data.ndim == 1:
            data = data[None]
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Boxes(self.data[idx], self.orig_shape)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def xywh(self):
        b = self.data[:, :4]
        return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2, b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.asarray([w, h, w, h], np.float32)

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.asarray([w, h, w, h], np.float32)


class Results:
    """Detections of one image."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str], boxes: Optional[np.ndarray] = None,
                 speed: Optional[Dict[str, float]] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes) if self.boxes is not None else 0

    def __getitem__(self, idx):
        return Results(self.orig_img, self.path, self.names,
                       boxes=self.boxes.data[idx] if self.boxes is not None else None)

    def new(self, boxes: Optional[np.ndarray] = None):
        return Results(self.orig_img, self.path, self.names, boxes=boxes)

    @property
    def verbose_line(self) -> str:
        if not len(self):
            return "(no detections)"
        counts: Dict[str, int] = {}
        for c in self.boxes.cls.astype(int):
            name = self.names.get(int(c), str(c))
            counts[name] = counts.get(name, 0) + 1
        return ", ".join(f"{v} {k}{'s' if v > 1 else ''}" for k, v in counts.items())

    def plot(self, line_width: Optional[int] = None, font_scale: float = 0.5, conf: bool = True,
             labels: bool = True) -> np.ndarray:
        """Draw the boxes on a copy of the original (BGR) image."""
        import cv2

        img = self.orig_img.copy()
        lw = line_width or max(round(sum(img.shape[:2]) / 2 * 0.003), 2)
        for row in self.boxes.data if self.boxes is not None else ():
            x1, y1, x2, y2 = row[:4].astype(int)
            cf, cls = row[-2], int(row[-1])
            color = _class_color(cls)
            cv2.rectangle(img, (x1, y1), (x2, y2), color, lw)
            if labels:
                label = f"{self.names.get(cls, cls)}" + (f" {cf:.2f}" if conf else "")
                cv2.putText(img, label, (x1, max(y1 - 4, 12)), cv2.FONT_HERSHEY_SIMPLEX, font_scale, color,
                            max(lw - 1, 1))
        return img

    def save(self, filename: str, **plot_kwargs):
        import cv2

        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(filename), self.plot(**plot_kwargs))
        return filename


def _class_color(cls: int):
    palette = [
        (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255), (49, 210, 207),
        (10, 249, 72), (23, 204, 146), (134, 219, 61), (52, 147, 26), (187, 212, 0),
        (168, 153, 44), (255, 194, 0), (147, 69, 52), (255, 115, 100), (236, 24, 0),
        (255, 56, 132), (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
    ]
    return palette[cls % len(palette)]
