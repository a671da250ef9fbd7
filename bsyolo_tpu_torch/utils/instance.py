"""Box, polygon and keypoint containers (counterpart of ``bsyolo_tpu/utils/instance.py``).

``Bboxes`` (xyxy, xywh or ltwh) and ``Instances`` (boxes with polygon segments
and keypoints) scale, normalize, pad, flip, clip and concatenate together, in
numpy, for custom augmentations and dataset tools. The port's own training
samples carry the same payloads as plain arrays (``data/augment.py``).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

_FORMATS = ("xyxy", "xywh", "ltwh")


def _to_xyxy(b: np.ndarray, fmt: str) -> np.ndarray:
    out = b.astype(np.float32).copy()
    if fmt == "xywh":  # center xywh
        out[:, 0] = b[:, 0] - b[:, 2] / 2
        out[:, 1] = b[:, 1] - b[:, 3] / 2
        out[:, 2] = b[:, 0] + b[:, 2] / 2
        out[:, 3] = b[:, 1] + b[:, 3] / 2
    elif fmt == "ltwh":  # top-left xywh
        out[:, 2] = b[:, 0] + b[:, 2]
        out[:, 3] = b[:, 1] + b[:, 3]
    return out


def _from_xyxy(b: np.ndarray, fmt: str) -> np.ndarray:
    out = b.astype(np.float32).copy()
    if fmt == "xywh":
        out[:, 0] = (b[:, 0] + b[:, 2]) / 2
        out[:, 1] = (b[:, 1] + b[:, 3]) / 2
        out[:, 2] = b[:, 2] - b[:, 0]
        out[:, 3] = b[:, 3] - b[:, 1]
    elif fmt == "ltwh":
        out[:, 2] = b[:, 2] - b[:, 0]
        out[:, 3] = b[:, 3] - b[:, 1]
    return out


class Bboxes:
    """Format-aware box container (reference instance.py:34)."""

    def __init__(self, bboxes: np.ndarray, format: str = "xyxy"):
        assert format in _FORMATS, f"format must be one of {_FORMATS}"
        b = np.asarray(bboxes, np.float32)
        b = b[None, :] if b.ndim == 1 else b
        assert b.ndim == 2 and b.shape[1] == 4
        self.bboxes = b
        self.format = format

    def convert(self, format: str):
        assert format in _FORMATS
        if format != self.format:
            self.bboxes = _from_xyxy(_to_xyxy(self.bboxes, self.format), format)
            self.format = format

    def areas(self) -> np.ndarray:
        x = _to_xyxy(self.bboxes, self.format)
        return (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])

    def mul(self, scale):
        from numbers import Number

        s = (scale,) * 4 if isinstance(scale, Number) or np.isscalar(scale) else tuple(scale)
        self.bboxes = self.bboxes * np.asarray(s, np.float32)[None]

    def add(self, offset):
        from numbers import Number

        o = (offset,) * 4 if isinstance(offset, Number) or np.isscalar(offset) else tuple(offset)
        self.bboxes = self.bboxes + np.asarray(o, np.float32)[None]

    def __len__(self):
        return len(self.bboxes)

    def __getitem__(self, index) -> "Bboxes":
        b = self.bboxes[index]
        return Bboxes(b.reshape(-1, 4), self.format)

    @classmethod
    def concatenate(cls, boxes_list: List["Bboxes"], axis: int = 0) -> "Bboxes":
        assert boxes_list
        fmt = boxes_list[0].format
        assert all(b.format == fmt for b in boxes_list)
        return cls(np.concatenate([b.bboxes for b in boxes_list], axis=axis), fmt)


class Instances:
    """Boxes + polygon segments + keypoints moved together
    (reference instance.py:185)."""

    def __init__(
        self,
        bboxes: np.ndarray,
        segments: Optional[np.ndarray] = None,
        keypoints: Optional[np.ndarray] = None,
        bbox_format: str = "xywh",
        normalized: bool = True,
    ):
        self._bboxes = Bboxes(bboxes, bbox_format)
        self.keypoints = None if keypoints is None else np.asarray(keypoints, np.float32)
        self.normalized = normalized
        self.segments = (
            np.zeros((len(self._bboxes), 0, 2), np.float32)
            if segments is None or len(segments) == 0
            else np.asarray(segments, np.float32)
        )

    # --- geometry ops -------------------------------------------------
    def convert_bbox(self, format: str):
        self._bboxes.convert(format)

    @property
    def bbox_areas(self) -> np.ndarray:
        return self._bboxes.areas()

    def scale(self, scale_w: float, scale_h: float, bbox_only: bool = False):
        self._bboxes.mul((scale_w, scale_h, scale_w, scale_h))
        if bbox_only:
            return
        self.segments[..., 0] *= scale_w
        self.segments[..., 1] *= scale_h
        if self.keypoints is not None:
            self.keypoints[..., 0] *= scale_w
            self.keypoints[..., 1] *= scale_h

    def denormalize(self, w: int, h: int):
        if not self.normalized:
            return
        self.scale(w, h)
        self.normalized = False

    def normalize(self, w: int, h: int):
        if self.normalized:
            return
        self.scale(1 / w, 1 / h)
        self.normalized = True

    def add_padding(self, padw: int, padh: int):
        assert not self.normalized, "you should add padding with absolute coordinates."
        self._bboxes.add((padw, padh, padw, padh))
        self.segments[..., 0] += padw
        self.segments[..., 1] += padh
        if self.keypoints is not None:
            self.keypoints[..., 0] += padw
            self.keypoints[..., 1] += padh

    def flipud(self, h: int):
        if self._bboxes.format == "xyxy":
            y1 = self.bboxes[:, 1].copy()
            y2 = self.bboxes[:, 3].copy()
            self.bboxes[:, 1] = h - y2
            self.bboxes[:, 3] = h - y1
        else:
            self.bboxes[:, 1] = h - self.bboxes[:, 1]
        self.segments[..., 1] = h - self.segments[..., 1]
        if self.keypoints is not None:
            self.keypoints[..., 1] = h - self.keypoints[..., 1]

    def fliplr(self, w: int):
        if self._bboxes.format == "xyxy":
            x1 = self.bboxes[:, 0].copy()
            x2 = self.bboxes[:, 2].copy()
            self.bboxes[:, 0] = w - x2
            self.bboxes[:, 2] = w - x1
        else:
            self.bboxes[:, 0] = w - self.bboxes[:, 0]
        self.segments[..., 0] = w - self.segments[..., 0]
        if self.keypoints is not None:
            self.keypoints[..., 0] = w - self.keypoints[..., 0]

    def clip(self, w: int, h: int):
        fmt = self._bboxes.format
        self.convert_bbox("xyxy")
        self.bboxes[:, [0, 2]] = self.bboxes[:, [0, 2]].clip(0, w)
        self.bboxes[:, [1, 3]] = self.bboxes[:, [1, 3]].clip(0, h)
        if fmt != "xyxy":
            self.convert_bbox(fmt)
        self.segments[..., 0] = self.segments[..., 0].clip(0, w)
        self.segments[..., 1] = self.segments[..., 1].clip(0, h)
        if self.keypoints is not None:
            self.keypoints[..., 0] = self.keypoints[..., 0].clip(0, w)
            self.keypoints[..., 1] = self.keypoints[..., 1].clip(0, h)

    def remove_zero_area_boxes(self) -> np.ndarray:
        good = self.bbox_areas > 0
        if not good.all():
            self._bboxes = self._bboxes[good]
            if len(self.segments):
                self.segments = self.segments[good]
            if self.keypoints is not None:
                self.keypoints = self.keypoints[good]
        return good

    def update(self, bboxes, segments=None, keypoints=None):
        self._bboxes = Bboxes(bboxes, self._bboxes.format)
        if segments is not None:
            self.segments = np.asarray(segments, np.float32)
        if keypoints is not None:
            self.keypoints = np.asarray(keypoints, np.float32)

    # --- container protocol -------------------------------------------
    def __len__(self):
        return len(self._bboxes)

    def __getitem__(self, index) -> "Instances":
        segments = self.segments[index] if len(self.segments) else self.segments
        keypoints = self.keypoints[index] if self.keypoints is not None else None
        bboxes = self.bboxes[index]
        return Instances(
            bboxes.reshape(-1, 4),
            segments=segments.reshape(-1, *self.segments.shape[1:]) if len(self.segments) else None,
            keypoints=keypoints,
            bbox_format=self._bboxes.format,
            normalized=self.normalized,
        )

    @property
    def bboxes(self) -> np.ndarray:
        return self._bboxes.bboxes

    @classmethod
    def concatenate(cls, instances_list: List["Instances"], axis: int = 0) -> "Instances":
        assert instances_list
        fmt = instances_list[0]._bboxes.format
        norm = instances_list[0].normalized
        assert all(i._bboxes.format == fmt and i.normalized == norm for i in instances_list)
        boxes = np.concatenate([i.bboxes for i in instances_list], axis=axis)
        seg_lens = {i.segments.shape[1] for i in instances_list}
        if len(seg_lens) > 1:  # resample ragged polygons to a common length
            n = max(seg_lens)
            segs = np.concatenate(
                [_resample_segments(i.segments, n) for i in instances_list], axis=axis
            )
        else:
            segs = np.concatenate([i.segments for i in instances_list], axis=axis)
        kpts = (
            np.concatenate([i.keypoints for i in instances_list], axis=axis)
            if instances_list[0].keypoints is not None
            else None
        )
        return cls(boxes, segs, kpts, bbox_format=fmt, normalized=norm)


def _resample_segments(segments: np.ndarray, n: int) -> np.ndarray:
    """(N, m, 2) polygons -> (N, n, 2) by linear interpolation along the ring
    (reference ops.resample_segments)."""
    if segments.shape[1] == 0:
        return np.zeros((segments.shape[0], n, 2), np.float32)
    out = np.zeros((segments.shape[0], n, 2), np.float32)
    for i, s in enumerate(segments):
        ring = np.concatenate([s, s[:1]], axis=0)
        t = np.linspace(0, len(ring) - 1, n)
        out[i, :, 0] = np.interp(t, np.arange(len(ring)), ring[:, 0])
        out[i, :, 1] = np.interp(t, np.arange(len(ring)), ring[:, 1])
    return out
