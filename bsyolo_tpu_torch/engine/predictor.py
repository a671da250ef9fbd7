"""Detection predictor (counterpart of ``bsyolo_tpu/engine/predictor.py``, detect branch).

Sources (numpy frames, lists of them, image files and directories) ->
letterbox on the model's device -> uint8 batches of ``batch`` frames (the
last one padded by repeating its last frame, so every batch has one shape)
-> /255, graph, fused decode and NMS on the device -> boxes scaled back to
each original frame -> ``Results``.

With ``augment=True`` (test-time augmentation) the graph runs three passes
per batch, identity, 0.83x with a left-right flip and 0.67x; each is decoded
by ``decode_detections``, mapped back to the input's pixels and tail-clipped,
and the merged passes go through one ``non_max_suppression``.
"""

from __future__ import annotations

import glob
import math
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bsyolo_tpu_torch.data.imread import imread
from bsyolo_tpu_torch.engine.results import Results
from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess
from bsyolo_tpu_torch.nn.heads import decode_detections
from bsyolo_tpu_torch.ops.boxes import scale_boxes
from bsyolo_tpu_torch.ops.letterbox import letterbox
from bsyolo_tpu_torch.ops.nms import non_max_suppression

IMG_SUFFIXES = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}
VID_SUFFIXES = {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".mpg", ".mpeg", ".wmv", ".webm"}


def iter_source(source) -> Iterator[tuple]:
    """Yield (BGR frame, path) from an array (uint8, or float32 on the 0-255 scale), a list,
    an image file, a directory or a glob pattern (``*``, ``**`` recursive), in sorted order."""
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
                im = imread(f)
                if im is not None:
                    yield im, str(f)
        return
    s = str(source)
    if "*" in s:
        for f in sorted(glob.glob(s, recursive=True)):
            im = imread(f)
            if im is not None:
                yield im, f
        return
    if p.suffix.lower() in VID_SUFFIXES or s.endswith(".streams") or s.isnumeric() or "://" in s:
        raise NotImplementedError(f"video and stream sources ({s}) are not ported yet (ROADMAP queue 1, item 17)")
    im = imread(p)
    if im is None:
        raise FileNotFoundError(f"cannot read source: {source}")
    yield im, s


def _stack(lbs) -> torch.Tensor:
    """One batch of letterboxed frames: uint8 where every frame is uint8, else float32."""
    if any(t.dtype != torch.uint8 for t in lbs):
        lbs = [t.float() for t in lbs]
    return torch.stack(lbs)


# TTA passes (scale, left-right flip), as the reference's _predict_augment
TTA_PASSES = ((1.0, False), (0.83, True), (0.67, False))


def scale_img(x: torch.Tensor, ratio: float, gs: int) -> torch.Tensor:
    """(B, C, H, W) float image scaled by ``ratio`` (bilinear, antialiased when it
    shrinks, as ``jax.image.resize``) and padded at the bottom and right with
    0.447 up to the multiple of ``gs`` above ``H * ratio`` and ``W * ratio``."""
    ih, iw = x.shape[2:]
    nh, nw = int(ih * ratio), int(iw * ratio)
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    ph = math.ceil(ih * ratio / gs) * gs - nh
    pw = math.ceil(iw * ratio / gs) * gs - nw
    return F.pad(x, (0, pw, 0, ph), value=0.447)  # the reference's imagenet-mean pad value


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
        augment: bool = False,
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
        self.augment = augment  # the port has only the plain Detect head, the one head that takes TTA

    @torch.inference_mode()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) RGB on the device, uint8 or float32 on the 0-255 scale -> (B, max_det, 6)
        detections on the device."""
        x = x.float() / 255.0
        if self.augment:
            return self._forward_augment(x)
        return detect_postprocess(
            self.model(x), self.spec.head_strides, self.spec.nc, conf_thres=self.conf, iou_thres=self.iou,
            max_det=self.max_det, agnostic=self.agnostic_nms, reg_max=self.spec.reg_max,
        )

    def _forward_augment(self, x: torch.Tensor) -> torch.Tensor:
        """TTA: each pass decoded to xywh in the input's pixels (de-scaled, de-flipped);
        the unscaled pass drops its last-level anchors and the most downscaled pass its
        first-level anchors; one NMS over the rest."""
        strides, nc = self.spec.head_strides, self.spec.nc
        iw = x.shape[3]
        outs = []
        for si, flip in TTA_PASSES:
            xi = x.flip(3) if flip else x
            if si != 1.0:
                xi = scale_img(xi, si, max(strides))  # pad to the largest stride: every level keeps its 4^i share
            p = decode_detections(self.model(xi), strides, nc, reg_max=self.spec.reg_max)
            xy, wh = p[..., :2] / si, p[..., 2:4] / si
            if flip:
                xy = torch.cat([iw - xy[..., :1], xy[..., 1:]], -1)
            outs.append(torch.cat([xy, wh, p[..., 4:]], -1))
        nl = len(strides)
        g = sum(4**i for i in range(nl))
        outs[0] = outs[0][:, : -(outs[0].shape[1] // g)]
        outs[-1] = outs[-1][:, (outs[-1].shape[1] // g) * 4 ** (nl - 1) :]
        return non_max_suppression(
            torch.cat(outs, 1), conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det, nc=nc,
            agnostic=self.agnostic_nms,
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
                yield frames, paths, _stack(lbs), t_pre
                frames, paths, lbs, t_pre = [], [], [], 0.0
        if frames:
            lbs += [lbs[-1]] * (self.batch - len(frames))
            yield frames, paths, _stack(lbs), t_pre

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
