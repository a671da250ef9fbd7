"""The predictor of the five tasks (counterpart of ``bsyolo_tpu/engine/predictor.py``).

Sources (numpy frames, lists of them, image files, directories, globs, video
files and URLs read with OpenCV every ``vid_stride``-th frame, webcam indices
and ``.streams`` lists through ``data/streams.py LoadStreams``) read and
decoded by a reader thread, which stages each batch's frames in pinned host
memory while the card runs the batch before (a queue of at most 4 batches)
-> asynchronous copy and letterbox on the model's device -> uint8 batches of
``batch`` frames (the last one padded by repeating its last frame, so every
batch has one shape) -> /255, graph, fused decode and NMS on the device ->
boxes scaled back to each original frame -> ``Results``.

With ``augment=True`` (test-time augmentation) the graph runs three passes
per batch, identity, 0.83x with a left-right flip and 0.67x; each is decoded
by ``decode_detections``, mapped back to the input's pixels and tail-clipped,
and the merged passes go through one ``non_max_suppression``. Only the Detect
graph takes it: task graphs and YOLOv10 warn and predict at one scale, as the
JAX package does.

YOLOv10 (a v10Detect head) predicts without NMS: its one-to-one levels go
through ``decode_detections`` (one launch of the xywh decode kernel per
batch) and ``postprocess_e2e``, and rows at or below ``conf`` become padding.
RT-DETR (an RTDETRDecoder head) predicts without NMS too: ``decode_rtdetr``
takes the ``max_det`` queries of highest score, and those at or below
``conf`` become padding; it takes no TTA either.

Segment and Pose graphs decode and suppress as Detect does
(``detect_postprocess(return_idx=True)``, one launch of the box decode kernel
per batch, on a head whose levels carry the mask coefficients or keypoints
after the class logits), then gather each kept row's extra channels. Segment:
the masks of the kept rows are assembled on the card (``ops/masks.py
process_mask`` at the network input's size), cut to the letterboxed frame,
resized to the original frame (OpenCV's float INTER_LINEAR) and thresholded at
0.5 there; with ``retina_masks`` the coefficients and prototypes come to the
host, which assembles each mask at the frame's own size (the reference's
``process_mask_native``). Pose: keypoints decoded in pixels, then mapped back
to the frame.

OBB graphs decode rotated boxes (``decode_obb``) and suppress them by probIoU
within a class (``nms_rotated``) on the card; the kept rows' centres and sizes
are mapped back to the frame, their angles kept. Classify graphs run the same
letterboxed batches, and the softmax of the logits is taken on the card: one
(B, nc) copy to the host per batch.
"""

from __future__ import annotations

import glob
import math
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bsyolo_tpu_torch.data.imread import imread
from bsyolo_tpu_torch.data.streams import LoadStreams
from bsyolo_tpu_torch.engine.results import Results
from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess
from bsyolo_tpu_torch.nn.heads import (decode_detections, decode_extras, decode_keypoints, decode_obb, gather_anchors,
                                       postprocess_e2e)
from bsyolo_tpu_torch.nn.transformer import decode_rtdetr
from bsyolo_tpu_torch.ops.boxes import scale_boxes
from bsyolo_tpu_torch.ops.letterbox import letterbox, letterbox_params
from bsyolo_tpu_torch.ops.masks import process_mask, resize_linear
from bsyolo_tpu_torch.ops.nms import non_max_suppression
from bsyolo_tpu_torch.ops.obb import nms_rotated
from bsyolo_tpu_torch.utils import CV2_VIDEO, LOGGER, import_cv2

IMG_SUFFIXES = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}
VID_SUFFIXES = {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".mpg", ".mpeg", ".wmv", ".webm"}


def iter_source(source, vid_stride: int = 1, stream_buffer: bool = False) -> Iterator[tuple]:
    """Yield (BGR frame, path) from an array (uint8, or float32 on the 0-255 scale), a list,
    an image file, a directory or a glob pattern (``*``, ``**`` recursive), in sorted order; from a
    video file or an rtsp/http(s) URL every ``vid_stride``-th frame (path ``<source>#frame<n>``);
    from a webcam index or a ``.streams`` list the streams' lock-step frames (``LoadStreams``, every
    frame with ``stream_buffer``, else the latest). Video and streams are decoded with OpenCV;
    closing the generator releases them."""
    if isinstance(source, np.ndarray):
        yield source, "array"
        return
    if isinstance(source, (list, tuple)):
        for s in source:
            yield from iter_source(s, vid_stride, stream_buffer)
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
    if s.endswith(".streams") or (isinstance(source, str) and source.isnumeric()):
        streams = LoadStreams(source, vid_stride=vid_stride, buffer=stream_buffer)
        try:
            for frames, paths in streams:
                yield from zip(frames, paths)
        finally:
            streams.close()
        return
    if p.suffix.lower() in VID_SUFFIXES or s.startswith(("rtsp://", "http://", "https://")):
        cap = import_cv2("reading video", CV2_VIDEO).VideoCapture(s)
        n = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if n % vid_stride == 0:
                    yield frame, f"{source}#frame{n}"
                n += 1
        finally:
            cap.release()
        return
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
        stream_buffer: bool = False,
        retina_masks: bool = False,
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
        self.task = getattr(spec, "task", "detect")
        self.e2e = spec.head.module == "v10Detect"
        self.rtdetr = spec.head.module == "RTDETRDecoder"
        if augment and (self.task != "detect" or self.e2e or self.rtdetr):
            LOGGER.warning("augment=True is only supported for Detect-head models; reverting to single-scale "
                           "prediction")
            augment = False
        if agnostic_nms and self.task == "obb":
            LOGGER.warning("agnostic_nms: the rotated NMS suppresses within each class only, as in the JAX package")
        self.augment = augment
        self.retina_masks = retina_masks
        self.stream_buffer = stream_buffer
        # seconds of the last stream(): waiting on the reader's queue, and in all
        self.reader_wait = 0.0
        self.wall = 0.0

    @torch.inference_mode()
    def forward(self, x: torch.Tensor):
        """(B, 3, S, S) RGB on the device, uint8 or float32 on the 0-255 scale -> (B, max_det, 6)
        detections on the device; for a Segment graph also the rows' (B, max_det, nm) mask
        coefficients and the (B, nm, Hm, Wm) prototypes, for a Pose graph the rows'
        (B, max_det, nkpt, ndim) keypoints in input pixels (zeros on padding rows); for an OBB graph
        (B, min(max_det, 512, A), 7) rotated rows, for a Classify graph (B, nc) probabilities."""
        x = x.float() / 255.0
        if self.augment:
            return self._forward_augment(x)
        out = self.model(x)
        if self.task == "classify":
            return torch.softmax(out.float(), -1)
        if self.task == "obb":
            return nms_rotated(decode_obb(out, self.spec.head_strides, self.spec.nc, self.spec.reg_max),
                               conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det, nc=self.spec.nc)
        if self.rtdetr:  # NMS-free: the decoder's top queries, those at or below conf as padding
            return decode_rtdetr(out, tuple(x.shape[2:]), self.conf, self.max_det)
        strides, nc = self.spec.head_strides, self.spec.nc
        if self.e2e:  # NMS-free: the one-to-one head's top rows, those at or below conf as padding
            dets = postprocess_e2e(decode_detections(out["one2one"], strides, nc, self.spec.reg_max), self.max_det, nc)
            ok = dets[..., 4:5] > self.conf
            return torch.cat([dets[..., :5] * ok, torch.where(ok, dets[..., 5:], -1.0)], -1)
        feats = out["feats"] if self.task == "segment" else out
        kw = dict(conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det, agnostic=self.agnostic_nms,
                  reg_max=self.spec.reg_max)
        if self.task == "detect":
            return detect_postprocess(feats, strides, nc, **kw)
        dets, idx = detect_postprocess(feats, strides, nc, return_idx=True, **kw)
        extras = decode_extras(feats, nc, self.spec.reg_max)  # (B, A, nm | nk)
        if self.task == "pose":
            extras = decode_keypoints(extras, feats, strides, self.spec.kpt_shape)  # (B, A, nkpt, ndim)
        sel = gather_anchors(extras, idx)
        if self.task == "segment":
            return dets, sel, out["proto"]
        return dets, sel

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

    def _batches(self, source, vid_stride: int = 1):
        """(frames, paths, (B, 3, S, S) batch on the device, preprocess seconds), in the source's
        order. A reader thread reads, decodes and stages frames (pinned memory on a card) into a
        queue of at most 4 batches while the consumer copies, letterboxes and runs the batch
        before; an error in the reader is raised here. A consumer that stops early releases the
        reader, which then closes the source (videos, streams), within a second."""
        q: queue.Queue = queue.Queue(maxsize=4)
        stop = object()
        err: list = []
        abandoned = threading.Event()
        pin = self.device.type == "cuda"

        def put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stage(frames):
            t0 = time.perf_counter()
            staged = [torch.from_numpy(np.ascontiguousarray(f)) for f in frames]
            if pin:
                staged = [t.pin_memory() for t in staged]
            return staged, time.perf_counter() - t0

        def reader():
            src = iter_source(source, vid_stride, self.stream_buffer)
            frames, paths = [], []
            try:
                for frame, path in src:
                    frames.append(frame)
                    paths.append(path)
                    if len(frames) == self.batch:
                        if not put((frames, paths, *stage(frames))):
                            return
                        frames, paths = [], []
                if frames:
                    put((frames, paths, *stage(frames)))
            except Exception as e:  # raised again in the consumer
                err.append(e)
            finally:
                src.close()  # a consumer that stopped early releases the video or the streams here
                put(stop)

        thread = threading.Thread(target=reader, name="predict-reader", daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.reader_wait += time.perf_counter() - t0
                if item is stop:
                    break
                frames, paths, staged, t_pre = item
                t0 = time.perf_counter()
                lbs = [letterbox(t, (self.imgsz, self.imgsz), self.device) for t in staged]
                lbs += [lbs[-1]] * (self.batch - len(lbs))
                x = _stack(lbs)
                yield frames, paths, x, t_pre + time.perf_counter() - t0
        finally:
            abandoned.set()
            thread.join(timeout=1.0)
        if err:
            raise err[0]

    def stream(self, source, vid_stride: int = 1, verbose: bool = False) -> Iterator[Results]:
        """``Results`` per frame, in order; closing the generator closes the source (video, streams).
        ``reader_wait`` and ``wall`` accumulate the run's seconds waiting on the reader and in all."""
        self.reader_wait = self.wall = 0.0
        t_start = time.perf_counter()
        batches = self._batches(source, vid_stride)
        try:
            for frames, paths, x, t_pre in batches:
                t1 = time.perf_counter()
                out = self.forward(x)
                if self.task in ("detect", "obb", "classify"):
                    out = (out,)
                dets = out[0].cpu().numpy()  # the copy waits for the device
                inf_ms = (time.perf_counter() - t1) * 1000 / len(frames)
                pre_ms = t_pre * 1000 / len(frames)
                if self.task == "pose" or (self.task == "segment" and self.retina_masks):
                    out = tuple(t.cpu() for t in out)
                for i, (frame, path) in enumerate(zip(frames, paths)):
                    t2 = time.perf_counter()
                    if self.task == "classify":
                        res = Results(frame, path, self.names, probs=dets[i])
                    elif self.task == "obb":
                        res = self._to_results_obb(dets[i], frame, path)
                    elif self.task == "segment" and self.retina_masks:
                        res = self._to_results_retina(dets[i], out[1][i], out[2][i], frame, path)
                    elif self.task == "segment":
                        res = self._to_results_segment(dets[i], out[1][i], out[2][i], frame, path)
                    elif self.task == "pose":
                        res = self._to_results_pose(dets[i], out[1][i].numpy(), frame, path)
                    else:
                        res = self._to_results(dets[i], frame, path)
                    res.speed = {"preprocess": pre_ms, "inference": inf_ms,
                                 "postprocess": (time.perf_counter() - t2) * 1000}
                    if verbose:
                        print(f"{path}: {res.verbose_line} ({inf_ms:.1f} ms)")
                    yield res
        finally:
            batches.close()
            self.wall = time.perf_counter() - t_start

    def _keep(self, dets: np.ndarray) -> np.ndarray:
        """Indices of the rows to report: the kept (conf > 0) rows of the ``classes`` asked for."""
        keep = np.flatnonzero(dets[:, 4] > 0)
        if self.classes is not None and len(keep):
            keep = keep[np.isin(dets[keep, 5].astype(int), self.classes)]
        return keep

    def _frame_rows(self, d: np.ndarray, frame: np.ndarray) -> np.ndarray:
        """Kept rows with their boxes scaled back to the frame's pixels."""
        if not len(d):
            return np.zeros((0, 6), np.float32)
        boxes = scale_boxes((self.imgsz, self.imgsz), torch.from_numpy(d[:, :4]), frame.shape[:2]).numpy()
        return np.concatenate([boxes, d[:, 4:6]], -1)

    def _to_results(self, dets: np.ndarray, frame: np.ndarray, path: str) -> Results:
        return Results(frame, path, self.names, boxes=self._frame_rows(dets[self._keep(dets)], frame))

    def _to_results_segment(self, dets: np.ndarray, coeffs: torch.Tensor, proto: torch.Tensor, frame: np.ndarray,
                            path: str) -> Results:
        """Masks of the kept rows assembled on the device at the input's size, the letterbox
        padding cut off, resized to the frame (float INTER_LINEAR), thresholded at 0.5."""
        keep = self._keep(dets)
        d = dets[keep]
        if not len(d):
            return Results(frame, path, self.names, boxes=np.zeros((0, 6), np.float32))
        k = torch.from_numpy(keep).to(coeffs.device)
        masks = process_mask(proto, coeffs[k], torch.from_numpy(d[:, :4]).to(coeffs.device), (self.imgsz, self.imgsz))
        h0, w0 = frame.shape[:2]
        _, (pw_f, ph_f), (ws, hs) = letterbox_params((h0, w0), (self.imgsz, self.imgsz))
        ph, pw = round(ph_f - 0.1), round(pw_f - 0.1)
        masks = (resize_linear(masks[:, ph : ph + hs, pw : pw + ws], (h0, w0)) > 0.5).float()  # 0/1 on the device:
        return Results(frame, path, self.names, boxes=self._frame_rows(d, frame), masks=masks.cpu().numpy())  # no host cast

    def _to_results_retina(self, dets: np.ndarray, coeffs: torch.Tensor, proto: torch.Tensor, frame: np.ndarray,
                           path: str) -> Results:
        """``retina_masks``, on the host: sigmoid(coefficients . prototypes) at prototype size, the
        letterbox padding cut off there, resized to the frame (float INTER_LINEAR), cut to each box in
        the frame's pixels, thresholded at 0.5."""
        keep = self._keep(dets)
        d = self._frame_rows(dets[keep], frame)
        if not len(d):
            return Results(frame, path, self.names, boxes=d)
        h0, w0 = frame.shape[:2]
        nm, ph, pw = proto.shape
        c = coeffs[torch.from_numpy(keep)].float().numpy()
        m = c @ proto.reshape(nm, -1).float().numpy()
        m = torch.from_numpy(1.0 / (1.0 + np.exp(-m.reshape(-1, ph, pw))))
        _, (pad_w, pad_h), _ = letterbox_params((h0, w0), (self.imgsz, self.imgsz))
        top = max(int(round(pad_h / self.imgsz * ph - 0.1)), 0)
        left = max(int(round(pad_w / self.imgsz * pw - 0.1)), 0)
        m = resize_linear(m[:, top : ph - top, left : pw - left], (h0, w0)).numpy()
        yy = np.arange(h0, dtype=np.float32)[None, :, None]
        xx = np.arange(w0, dtype=np.float32)[None, None, :]
        x1, y1, x2, y2 = (d[:, j].reshape(-1, 1, 1) for j in range(4))
        m = m * ((xx >= x1) & (xx < x2) & (yy >= y1) & (yy < y2))
        return Results(frame, path, self.names, boxes=d, masks=(m > 0.5).astype(np.float32))

    def _to_results_obb(self, dets: np.ndarray, frame: np.ndarray, path: str) -> Results:
        """Kept rotated rows, their centres and sizes mapped from the letterboxed input back to the frame."""
        d = dets[self._keep(dets)].copy()
        h0, w0 = frame.shape[:2]
        gain = min(self.imgsz / h0, self.imgsz / w0)
        d[:, 0] = (d[:, 0] - round((self.imgsz - w0 * gain) / 2 - 0.1)) / gain
        d[:, 1] = (d[:, 1] - round((self.imgsz - h0 * gain) / 2 - 0.1)) / gain
        d[:, 2:4] /= gain
        return Results(frame, path, self.names, obb=d)

    def _to_results_pose(self, dets: np.ndarray, kpts: np.ndarray, frame: np.ndarray, path: str) -> Results:
        """Kept rows and their keypoints, mapped from the letterboxed input back to the frame."""
        keep = self._keep(dets)
        d, k = dets[keep], kpts[keep]
        if not len(d):
            return Results(frame, path, self.names, boxes=np.zeros((0, 6), np.float32),
                           keypoints=np.zeros((0,) + kpts.shape[1:], np.float32))
        h0, w0 = frame.shape[:2]
        gain = min(self.imgsz / h0, self.imgsz / w0)
        pw = round((self.imgsz - w0 * gain) / 2 - 0.1)
        ph = round((self.imgsz - h0 * gain) / 2 - 0.1)
        k = k.copy()
        k[..., 0] = (k[..., 0] - pw) / gain
        k[..., 1] = (k[..., 1] - ph) / gain
        return Results(frame, path, self.names, boxes=self._frame_rows(d, frame), keypoints=k)

    def __call__(self, source, **kwargs) -> List[Results]:
        return list(self.stream(source, **kwargs))
