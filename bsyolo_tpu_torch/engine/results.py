"""Results API of the five tasks (counterpart of ``bsyolo_tpu/engine/results.py``).

Host numpy containers: by the time results exist, the device work is done.
``save_txt``, ``save_crop`` (JPEG crops through the port's own encoder),
``summary``, ``to_json`` and the mask contours (``Masks.xy``, ``xyn``: the
port's own border follower, ``ops/contours.py``, where the JAX package calls
``cv2.findContours``) need no OpenCV; drawing (``plot``, ``save``) does, and
imports it only when called (without it they raise ImportError naming the
ROADMAP item).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from bsyolo_tpu_torch.data.imread import imwrite
from bsyolo_tpu_torch.ops.contours import largest_contour
from bsyolo_tpu_torch.utils import CV2_DRAWING, import_cv2


class Boxes:
    """Detection boxes; ``data`` is (n, 6): x1, y1, x2, y2, conf, cls, or (n, 7) after tracking:
    x1, y1, x2, y2, track_id, conf, cls."""

    def __init__(self, data: np.ndarray, orig_shape):
        if data.ndim == 1:
            data = data[None]
        self.data = data
        self.orig_shape = orig_shape
        self.is_track = data.shape[-1] == 7

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
    def id(self):
        return self.data[:, -3] if self.is_track else None

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


class Masks:
    """Instance masks; ``data`` is (n, H, W) float32 0/1 at the original image's size."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @functools.cached_property
    def xy(self):
        """Per mask, the (n, 2) float32 pixel points of its largest outer border (``ops/contours.py``, as
        the JAX package's ``cv2.findContours`` and ``contourArea``); (0, 2) for an empty mask. Traced once
        per ``Masks``: ``xyn`` and ``save_txt`` reuse it."""
        return [largest_contour(m > 0.5) for m in self.data]

    @property
    def xyn(self):
        """``xy`` normalized by the original image's width and height."""
        h, w = self.orig_shape
        scale = np.asarray([w, h], np.float32)
        return [c / scale for c in self.xy]


class Keypoints:
    """Pose keypoints; ``data`` is (n, nkpt, 2 or 3): x, y in pixels of the original image
    [, visibility in (0, 1)]."""

    def __init__(self, data: np.ndarray, orig_shape):
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        h, w = self.orig_shape
        return self.xy / np.asarray([w, h], np.float32)

    @property
    def conf(self):
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


def _corners(xywhr: np.ndarray) -> np.ndarray:
    """(n, 5) xywhr -> (n, 4, 2) float32 corners (``ops/obb.py xywhr2xyxyxyxy`` in float32)."""
    import torch

    from bsyolo_tpu_torch.ops.obb import xywhr2xyxyxyxy

    return xywhr2xyxyxyxy(torch.from_numpy(np.ascontiguousarray(xywhr, np.float32))).numpy()


class OBBoxes:
    """Rotated boxes; ``data`` is (n, 7): x, y, w, h, conf, cls, angle in radians, or (n, 8) with a track id
    after h."""

    def __init__(self, data: np.ndarray, orig_shape):
        if data.ndim == 1:
            data = data[None]
        self.data = data
        self.orig_shape = orig_shape
        self.is_track = data.shape[-1] == 8

    def __len__(self):
        return len(self.data)

    @property
    def xywhr(self):
        return np.concatenate([self.data[:, :4], self.data[:, -1:]], -1)

    @property
    def conf(self):
        return self.data[:, -3]

    @property
    def cls(self):
        return self.data[:, -2]

    @property
    def xyxyxyxy(self):
        return _corners(self.xywhr)


class Probs:
    """Class probabilities of one image, ``data`` (nc,)."""

    def __init__(self, data: np.ndarray):
        self.data = data

    @property
    def top1(self):
        return int(np.argmax(self.data))

    @property
    def top5(self):
        return np.argsort(-self.data)[:5].tolist()

    @property
    def top1conf(self):
        return float(self.data[self.top1])

    @property
    def top5conf(self):
        return self.data[self.top5]


class Results:
    """Detections of one image, with their masks (segment) or keypoints (pose); or its rotated boxes (OBB);
    or its class probabilities (classify)."""

    def __init__(self, orig_img: np.ndarray, path: str, names: Dict[int, str], boxes: Optional[np.ndarray] = None,
                 speed: Optional[Dict[str, float]] = None, masks: Optional[np.ndarray] = None,
                 keypoints: Optional[np.ndarray] = None, obb: Optional[np.ndarray] = None,
                 probs: Optional[np.ndarray] = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.obb = OBBoxes(obb, self.orig_shape) if obb is not None else None
        self.probs = Probs(probs) if probs is not None else None
        self.speed = speed or {}

    def __len__(self):
        for c in (self.boxes, self.obb):
            if c is not None:
                return len(c)
        return 0

    def __getitem__(self, idx):
        pick = lambda c: None if c is None else c.data[idx]
        return Results(self.orig_img, self.path, self.names, boxes=pick(self.boxes), masks=pick(self.masks),
                       keypoints=pick(self.keypoints), obb=pick(self.obb),
                       probs=None if self.probs is None else self.probs.data)

    def new(self, boxes: Optional[np.ndarray] = None):
        return Results(self.orig_img, self.path, self.names, boxes=boxes)

    @property
    def verbose_line(self) -> str:
        if self.probs is not None:
            return ", ".join(f"{self.names.get(j, str(j))} {float(self.probs.data[j]):.2f}" for j in self.probs.top5)
        if not len(self):
            return "(no detections)"
        counts: Dict[str, int] = {}
        for c in (self.boxes if self.boxes is not None else self.obb).cls.astype(int):
            name = self.names.get(int(c), str(c))
            counts[name] = counts.get(name, 0) + 1
        return ", ".join(f"{v} {k}{'s' if v > 1 else ''}" for k, v in counts.items())

    def save_txt(self, txt_file, save_conf: bool = False):
        """YOLO-format labels, one ``cls cx cy w h [kx ky [v] ...] [conf]`` line per box
        (normalized xywh, then each keypoint's normalized x, y and visibility for a pose result,
        6 decimals); for a segment result ``cls x1 y1 x2 y2 ...`` with the normalized polygon of the
        box's mask in place of the box (the box where the mask is empty); ``cls x1 y1 ... x4 y4 [conf]``
        per rotated box (its corners, normalized); the top 5 classes as ``conf name`` (2 decimals) for
        class probabilities; as the JAX package's ``Results.save_txt`` writes them."""
        lines = []
        h, w = self.orig_shape
        if self.probs is not None:
            lines = [f"{float(self.probs.data[j]):.2f} {self.names.get(int(j), j)}" for j in self.probs.top5]
        elif self.obb is not None:
            polys = self.obb.xyxyxyxy.reshape(len(self.obb), 8) / np.asarray([w, h] * 4, np.float32)
            for row, poly in zip(self.obb.data, polys):
                parts = [str(int(row[-2])), *(f"{v:.6f}" for v in poly)]
                if save_conf:
                    parts.append(f"{float(row[-3]):.6f}")
                lines.append(" ".join(parts))
        elif self.boxes is not None:
            kpts = self.keypoints
            polys = self.masks.xyn if self.masks is not None else ()
            for j, (row, xywhn) in enumerate(zip(self.boxes.data, self.boxes.xywhn)):
                poly = polys[j] if j < len(polys) else ()
                parts = [str(int(row[-1])), *(f"{v:.6f}" for v in (poly.reshape(-1) if len(poly) else xywhn))]
                if not len(poly) and kpts is not None and j < len(kpts.data):
                    kn, kc = kpts.xyn[j], kpts.conf[j] if kpts.conf is not None else None
                    for ki in range(len(kn)):
                        parts += [f"{kn[ki][0]:.6f}", f"{kn[ki][1]:.6f}"] + ([f"{kc[ki]:.6f}"] if kc is not None else [])
                if save_conf:
                    parts.append(f"{float(row[-2]):.6f}")
                lines.append(" ".join(parts))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines) + ("\n" if lines else ""))
        return txt_file

    def save_crop(self, save_dir, file_name: Optional[str] = None) -> int:
        """Each box's crop of the original image as ``save_dir/<class name>/<stem>_<i>.jpg`` (JPEG at
        quality 95, the bytes ``cv2.imwrite`` writes), the box clipped to the image; boxes that clip
        to nothing are skipped. Returns the number of crops written."""
        if self.boxes is None:
            return 0
        n = 0
        stem = Path(file_name or self.path or "im").stem or "im"
        h, w = self.orig_shape
        for i, row in enumerate(self.boxes.data):
            cls = int(row[-1])
            x1, y1, x2, y2 = int(max(0, row[0])), int(max(0, row[1])), int(min(w, row[2])), int(min(h, row[3]))
            if x2 <= x1 or y2 <= y1:
                continue
            d = Path(save_dir) / str(self.names.get(cls, str(cls)))
            d.mkdir(parents=True, exist_ok=True)
            imwrite(d / f"{stem}_{i}.jpg", self.orig_img[y1:y2, x1:x2])
            n += 1
        return n

    def summary(self, normalize: bool = False) -> list:
        """One dict per box: name, class, confidence (5 decimals), box x1/y1/x2/y2 (pixels to 2
        decimals, or normalized to 5), track_id for tracked boxes and the keypoints' x and y lists
        for a pose result; per rotated box its cx, cy, w, h and angle (5 decimals); for class
        probabilities one dict of the top class."""
        rows = []
        h, w = self.orig_shape
        div = (w, h, w, h) if normalize else (1, 1, 1, 1)
        nd = 5 if normalize else 2
        if self.probs is not None:
            top = self.probs.top1
            return [{"name": self.names.get(top, str(top)), "class": top,
                     "confidence": round(float(self.probs.top1conf), 5)}]
        if self.boxes is None and self.obb is not None:
            for row in self.obb.data:
                cls = int(row[-2])
                rec = {"name": self.names.get(cls, str(cls)), "class": cls, "confidence": round(float(row[-3]), 5)}
                if self.obb.is_track:
                    rec["track_id"] = int(row[4])
                rec["box"] = {"cx": round(float(row[0]) / div[0], nd), "cy": round(float(row[1]) / div[1], nd),
                              "w": round(float(row[2]) / div[0], nd), "h": round(float(row[3]) / div[1], nd),
                              "angle": round(float(row[-1]), 5)}
                rows.append(rec)
            return rows
        if self.boxes is None:
            return rows
        for i, row in enumerate(self.boxes.data):
            cls = int(row[-1])
            rec = {
                "name": self.names.get(cls, str(cls)),
                "class": cls,
                "confidence": round(float(row[-2]), 5),
                "box": {k: round(float(v) / d, 5 if normalize else 2) for k, v, d in zip(("x1", "y1", "x2", "y2"),
                                                                                      row[:4], div)},
            }
            if self.boxes.is_track:
                rec["track_id"] = int(row[4])
            if self.keypoints is not None and i < len(self.keypoints.data):
                k = self.keypoints.data[i]
                rec["keypoints"] = {a: [round(float(v) / div[j], 5 if normalize else 2) for v in k[:, j]]
                                    for j, a in enumerate(("x", "y"))}
            rows.append(rec)
        return rows

    def to_json(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def plot(self, line_width: Optional[int] = None, font_scale: float = 0.5, conf: bool = True,
             labels: bool = True, boxes: bool = True, masks: bool = True, kpts: bool = True,
             kpt_radius: int = 3) -> np.ndarray:
        """A copy of the original (BGR) image with the masks (blended in their class colour), the boxes
        (with ``id:`` labels on tracked boxes), the rotated boxes (``cv2.boxPoints`` polygons labelled at
        their centre) and the keypoints of visibility 0.5 or more drawn, as the JAX package's
        ``Results.plot``; ``boxes``, ``masks`` and ``kpts`` turn each layer off, ``labels`` and ``conf``
        the labels and their scores. Class probabilities are not drawn: such a result comes back as a
        copy of the image."""
        cv2 = import_cv2("Results.plot", CV2_DRAWING)

        img = self.orig_img.copy()
        lw = line_width or max(round(sum(img.shape[:2]) / 2 * 0.003), 2)
        if masks and self.masks is not None and len(self.masks.data):
            overlay = img.copy()
            for j, m in enumerate(self.masks.data):
                cls_j = int(self.boxes.data[j][-1]) if self.boxes is not None and j < len(self.boxes.data) else j
                overlay[m > 0.5] = _class_color(cls_j)
            img = cv2.addWeighted(img, 0.55, overlay, 0.45, 0)
        for row in self.boxes.data if boxes and self.boxes is not None else ():
            x1, y1, x2, y2 = row[:4].astype(int)
            cf, cls = row[-2], int(row[-1])
            color = _class_color(cls)
            cv2.rectangle(img, (x1, y1), (x2, y2), color, lw)
            if labels:
                tid = f"id:{int(row[4])} " if self.boxes.is_track else ""
                label = f"{tid}{self.names.get(cls, cls)}" + (f" {cf:.2f}" if conf else "")
                cv2.putText(img, label, (x1, max(y1 - 4, 12)), cv2.FONT_HERSHEY_SIMPLEX, font_scale, color,
                            max(lw - 1, 1))
        for row in self.obb.data if boxes and self.obb is not None else ():
            cx, cy, w, h = row[:4]
            ang, cls, cf = row[-1], int(row[-2]), row[-3]
            color = _class_color(cls)
            pts = cv2.boxPoints(((float(cx), float(cy)), (float(w), float(h)), float(np.degrees(ang))))
            cv2.polylines(img, [pts.astype(np.int32)], True, color, lw)
            if labels:
                label = f"{self.names.get(cls, cls)}" + (f" {cf:.2f}" if conf else "")
                cv2.putText(img, label, (int(cx), max(int(cy) - 4, 12)), cv2.FONT_HERSHEY_SIMPLEX, font_scale,
                            color, max(lw - 1, 1))
        for inst in self.keypoints.data if kpts and self.keypoints is not None else ():
            for p in inst:
                if len(p) > 2 and p[2] < 0.5:
                    continue
                cv2.circle(img, (int(p[0]), int(p[1])), kpt_radius, (0, 0, 255), -1)
        return img

    def save(self, filename: str, **plot_kwargs):
        cv2 = import_cv2("Results.save", CV2_DRAWING)

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
