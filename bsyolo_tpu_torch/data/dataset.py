"""YOLO-format datasets of the detect, segment, pose and OBB tasks (counterpart of ``bsyolo_tpu/data/dataset.py``).

A dataset YAML (path / train / val / names, and ``flip_idx`` for pose) names
image folders or lists; each image's labels are the sibling
``labels/<stem>.txt`` rows, normalized: ``class cx cy w h`` (detect),
``class x1 y1 ... xn yn`` polygons (segment; the box is the polygon's extent),
``class cx cy w h kx ky v ...`` (pose), ``class x1 y1 x2 y2 x3 y3 x4 y4``
corners (OBB; the box is the minimum-area rectangle around them, ``cv.min_area_rect``,
as xywhr with the angle in [-pi/4, 3pi/4)). Images are read by ``data/imread.py``
(PNG, BMP, JPEG and .npy without OpenCV) and pre-resized by ``data/cv.py``.
The parsed labels are cached in ``labels.cache.npz`` beside the label folder
in the JAX package's format and hash, so both packages share one cache.

A segment sample carries ``masks``: its instances' polygons (warped with the
image) filled at 1 / ``mask_ratio`` of the canvas (``cv.fill_poly``), larger
instances first so smaller ones win where they overlap, pixel value g + 1
for instance g, the instances reordered to match. A pose sample carries
``keypoints`` (max_gt, nkpt, 3): x, y normalized to the canvas and the
visibility. An OBB sample carries ``rboxes`` (max_gt, 5): x, y, w, h normalized to the canvas
and the angle in radians; in training the four corners are warped with the image and the
rectangle fitted again around them.
"""

from __future__ import annotations

import hashlib
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from bsyolo_tpu_torch.cfg import CFG_ROOT, read_yaml
from bsyolo_tpu_torch.data import cv
from bsyolo_tpu_torch.data.augment import (format_labels, mixup, mixup_task, resample_poly, train_transform,
                                           train_transform_task)
from bsyolo_tpu_torch.data.imread import image_size, imread
from bsyolo_tpu_torch.nn.parser import HEAD_TASKS
from bsyolo_tpu_torch.ops.letterbox import letterbox_image

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm", "npy"}
_DISK_CACHE = re.compile(r"\.\d+(\.\d+\.tmp)?\.npy$")  # the disk cache's own <stem>.<imgsz>.npy files


def load_dataset_yaml(path) -> Dict:
    """A dataset YAML with its paths resolved; a bare bundled name (``car.yaml``) resolves against
    ``cfg/datasets``, and its relative ``path`` against the settings' ``datasets_dir``."""
    path = Path(path)
    bundled = False
    if not path.exists() and path.name == str(path):
        cand = CFG_ROOT / "datasets" / path.name
        if cand.exists():
            path, bundled = cand, True
    d = read_yaml(path)
    root = Path(d.get("path", path.parent))
    if not root.is_absolute():
        if bundled:
            from bsyolo_tpu_torch.utils.settings import datasets_dir

            root = datasets_dir() / root.name
        else:
            root = (path.parent / root).resolve()
    out = dict(d)
    out["path"] = root

    def _resolve(v):
        if isinstance(v, (list, tuple)):
            return [_resolve(x) for x in v]
        p = Path(v)
        return str(p if p.is_absolute() else root / p)

    for split in ("train", "val", "test"):
        if d.get(split):
            out[split] = _resolve(d[split])
    names = d.get("names", {})
    if isinstance(names, list):
        names = dict(enumerate(names))
    out["names"] = {int(k): str(v) for k, v in names.items()}
    out["nc"] = d.get("nc", len(out["names"]))
    return out


def _rbox_from_corners(pts: np.ndarray) -> np.ndarray:
    """(cx, cy, w, h, r) float32 of the minimum-area rectangle around 4 corner points, w the longer side,
    the angle canonicalized into [-pi/4, 3pi/4), the OBB head's range."""
    (cx, cy), (bw, bh), ang = cv.min_area_rect(np.asarray(pts, np.float32))
    r = np.deg2rad(ang)
    if bw < bh:
        bw, bh = bh, bw
        r += np.pi / 2
    while r >= 3 * np.pi / 4:
        r -= np.pi
    while r < -np.pi / 4:
        r += np.pi
    return np.asarray([cx, cy, bw, bh, r], np.float32)


def img2label_path(img_path: str) -> str:
    """images/xxx.jpg -> labels/xxx.txt."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(img_path.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


class YOLODataset:
    """Dataset of one task: file listing, labels and the augment and letterbox paths of one sample."""

    POLY_PTS = 1000  # a segment polygon is resampled to this many points before it is warped

    def __init__(self, img_path, imgsz: int = 640, augment: bool = True, hyp: Optional[Dict] = None,
                 max_gt: int = 128, single_cls: bool = False, fraction: float = 1.0, task: str = "detect",
                 cache: object = False, mask_ratio: int = 4, flip_idx: Optional[List[int]] = None):
        if task == "classify":
            raise ValueError("classify data is folder-per-class: data/classify.py ClassificationDataset")
        if task not in HEAD_TASKS.values():
            raise ValueError(f"unknown task {task!r}")
        self.task = task
        self.mask_ratio = mask_ratio
        # left/right keypoint permutation for horizontal flips; None turns them off for pose
        self.flip_idx = None if flip_idx is None else np.asarray(flip_idx, np.int64)
        self.segments: Dict[int, list] = {}  # image -> per-row (n, 2) normalized polygon or None
        self.keypoints: Dict[int, list] = {}  # image -> per-row (nkpt, 3) normalized keypoints or None
        self.rboxes: Dict[int, list] = {}  # image -> per-row (5,) normalized xywhr or None (OBB)
        self.rcorners: Dict[int, list] = {}  # image -> per-row (4, 2) normalized corners or None (OBB)
        self.img_files = self._list_images(img_path)
        if fraction < 1.0:
            self.img_files = self.img_files[: max(1, round(len(self.img_files) * fraction))]
        if not self.img_files:
            raise FileNotFoundError(f"no images found in {img_path}")
        self.label_files = [img2label_path(f) for f in self.img_files]
        self.imgsz = imgsz
        self.augment = augment
        self.hyp = dict(hyp or {})
        self.max_gt = max_gt
        self.single_cls = single_cls
        if not self._load_cache():
            self.labels = [self._load_label(i) for i in range(len(self.img_files))]
            self._save_cache()
        if cache is True:
            cache = "ram"
        self._cache_mode = cache if cache in ("ram", "disk") else None
        self._ims: Optional[List[np.ndarray]] = None
        if self._cache_mode == "ram":
            self._ims = [self._read_image(i) for i in range(len(self.img_files))]

    # --- the label cache, in the JAX package's format -----------------------------------------------
    def _cache_path(self) -> Path:
        d = Path(self.label_files[0]).parent if self.label_files else Path(".")
        return d.with_suffix(".cache.npz")

    def _cache_hash(self) -> str:
        h = hashlib.sha1()
        h.update(f"v2:{self.task}:{self.single_cls}".encode())
        for f in self.label_files:
            try:
                st = os.stat(f)
                h.update(f"{f}:{st.st_mtime_ns}:{st.st_size}".encode())
            except OSError:
                h.update(f"{f}:missing".encode())
        return h.hexdigest()

    def _save_cache(self):
        def obj(x):
            a = np.empty(1, dtype=object)
            a[0] = x
            return a

        try:
            np.savez(self._cache_path(), hash=self._cache_hash(), labels=obj(self.labels), segments=obj(self.segments),
                     keypoints=obj(self.keypoints), rboxes=obj(self.rboxes), rcorners=obj(self.rcorners), allow_pickle=True)
        except OSError:
            pass  # a read-only label folder: the cache is best-effort

    def _load_cache(self) -> bool:
        path = self._cache_path()
        if not path.exists():
            return False
        try:
            z = np.load(path, allow_pickle=True)
            if str(z["hash"]) != self._cache_hash():
                return False
            self.labels = list(z["labels"][0])
            self.segments = dict(z["segments"][0])
            self.keypoints = dict(z["keypoints"][0])
            self.rboxes = dict(z["rboxes"][0])
            self.rcorners = dict(z["rcorners"][0])
            return True
        except Exception:
            return False

    @staticmethod
    def _list_images(img_path) -> List[str]:
        if isinstance(img_path, (list, tuple)):
            return [f for p in img_path for f in YOLODataset._list_images(p)]
        p = Path(img_path)
        if p.is_dir():
            return sorted(str(f) for f in p.rglob("*")
                          if f.suffix.lower().lstrip(".") in IMG_FORMATS and not _DISK_CACHE.search(f.name))
        if p.is_file() and p.suffix == ".txt":
            base = p.parent
            return [str(fp if fp.is_absolute() else base / fp)
                    for fp in (Path(line.strip()) for line in p.read_text().splitlines() if line.strip())]
        return [str(p)] if p.is_file() else []

    def _load_label(self, i: int):
        """(cls (n,), normalized xywh (n, 4) clipped to [0, 1]) from the label file's rows of 5 or more.
        Segment: a row of an odd count of 7 or more values is a polygon (kept in ``segments[i]``; its box
        is its extent). Pose: a row of 5 + 3 k values carries k keypoints (``keypoints[i]``). OBB: a row of
        9 values carries 4 corners (``rcorners[i]``), its box is the rectangle fitted around them
        (``rboxes[i]``, xywhr). Other rows of 5 or more are boxes (None in the task's payload)."""
        lp = self.label_files[i]
        if not os.path.exists(lp):
            return np.zeros((0,), np.float32), np.zeros((0, 4), np.float32)
        rows, polys, kpts, rbs, rcs = [], [], [], [], []
        for parts in (line.split() for line in Path(lp).read_text().splitlines()):
            if self.task == "segment" and len(parts) >= 7 and len(parts) % 2 == 1:
                vals = [float(x) for x in parts]
                poly = np.asarray(vals[1:], np.float32).reshape(-1, 2)
                lo, hi = poly.min(0), poly.max(0)
                rows.append([vals[0], *((lo + hi) / 2), *(hi - lo)])
                polys.append(poly)
            elif self.task == "obb" and len(parts) == 9:
                vals = [float(x) for x in parts]
                pts = np.asarray(vals[1:], np.float32).reshape(4, 2)
                rb = _rbox_from_corners(pts)
                rows.append([vals[0], *rb[:4]])
                rbs.append(rb)
                rcs.append(pts)
            elif self.task == "pose" and len(parts) > 5 and (len(parts) - 5) % 3 == 0:
                vals = [float(x) for x in parts]
                rows.append(vals[:5])
                kpts.append(np.asarray(vals[5:], np.float32).reshape(-1, 3))
            elif len(parts) >= 5:
                rows.append([float(x) for x in parts[:5]])
                polys.append(None)
                kpts.append(None)
                rbs.append(None)
                rcs.append(None)
        if not rows:
            return np.zeros((0,), np.float32), np.zeros((0, 4), np.float32)
        if self.task == "segment":
            self.segments[i] = polys
        if self.task == "pose":
            self.keypoints[i] = kpts
        if self.task == "obb":
            self.rboxes[i], self.rcorners[i] = rbs, rcs
        arr = np.asarray(rows, np.float32)
        cls = arr[:, 0] * (0 if self.single_cls else 1)
        return cls, np.clip(arr[:, 1:5], 0, 1)

    def __len__(self):
        return len(self.img_files)

    def load_image(self, i: int) -> np.ndarray:
        if self._ims is not None:
            return self._ims[i].copy()
        if self._cache_mode == "disk":
            npy = Path(self.img_files[i]).with_suffix(f".{self.imgsz}.npy")
            if npy.exists():
                try:
                    return np.load(npy)
                except (ValueError, EOFError, OSError):
                    pass
            im = self._read_image(i)
            try:  # publish atomically: workers may race on one image
                tmp = npy.with_suffix(f".{os.getpid()}.tmp.npy")
                np.save(tmp, im)
                os.replace(tmp, npy)
            except OSError:
                pass
            return im
        return self._read_image(i)

    def _read_image(self, i: int) -> np.ndarray:
        im = imread(self.img_files[i])
        if im is None:
            raise FileNotFoundError(self.img_files[i])
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:  # the long side to imgsz
            interp = cv.INTER_LINEAR if (self.augment or r > 1) else cv.INTER_AREA
            im = cv.resize(im, (min(int(w0 * r), self.imgsz), min(int(h0 * r), self.imgsz)), interp)
        return im

    def label_pixels(self, i: int, shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
        """(cls, xyxy in pixels of an image of ``shape``)."""
        cls, xywh = self.labels[i]
        h, w = shape
        if len(xywh) == 0:
            return cls, np.zeros((0, 4), np.float32)
        cx, cy, bw, bh = xywh[:, 0] * w, xywh[:, 1] * h, xywh[:, 2] * w, xywh[:, 3] * h
        return cls, np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)

    def image_shapes(self) -> np.ndarray:
        """(N, 2) original (h, w) per image from the file headers (imgsz where unreadable)."""
        if getattr(self, "_shapes", None) is None:
            shapes = np.zeros((len(self.img_files), 2), np.int32)
            for i, f in enumerate(self.img_files):
                try:
                    shapes[i] = image_size(f)
                except Exception:
                    shapes[i] = (self.imgsz, self.imgsz)
            self._shapes = shapes
        return self._shapes

    def get_sample(self, i: int, rng: np.random.Generator, mosaic: bool = True,
                   shape: Optional[Tuple[int, int]] = None) -> Dict:
        """One sample: img (uint8 RGB HWC), cls, bboxes (normalized xywh), mask, padded to max_gt, and
        the task's masks, keypoints or rboxes. ``shape``: the letterbox canvas of a rect val bucket, in place
        of the square."""
        if self.task != "detect":
            if self.augment:
                return self._aug_task_sample(i, rng, mosaic)
            if self.task == "obb":
                return self._val_obb_sample(i, shape)
            return self._val_task_sample(i, shape)
        if self.augment:
            use_mosaic = mosaic and rng.random() < self.hyp.get("mosaic", 1.0)
            idxs = [i] + list(rng.integers(0, len(self), 3)) if use_mosaic else [i]
            imgs = [self.load_image(j) for j in idxs]
            labels = [self.label_pixels(j, imgs[k].shape[:2]) for k, j in enumerate(idxs)]
            img, cls, boxes = train_transform(imgs, labels, self.imgsz, rng, self.hyp, mosaic=use_mosaic)
            if use_mosaic and rng.random() < self.hyp.get("mixup", 0.0):
                idxs2 = list(rng.integers(0, len(self), 4))
                imgs2 = [self.load_image(j) for j in idxs2]
                labels2 = [self.label_pixels(j, imgs2[k].shape[:2]) for k, j in enumerate(idxs2)]
                img2, cls2, boxes2 = train_transform(imgs2, labels2, self.imgsz, rng, self.hyp, mosaic=True)
                img, cls, boxes = mixup(img, (cls, boxes), img2, (cls2, boxes2), rng)
            if self.hyp.get("bgr", 0.0) and rng.random() < self.hyp.get("bgr", 0.0):
                img = np.ascontiguousarray(img[..., ::-1])
        else:
            im = self.load_image(i)
            cls, boxes = self.label_pixels(i, im.shape[:2])
            img, r, (dw, dh) = letterbox_image(im, shape or (self.imgsz, self.imgsz), scaleup=False)
            if len(boxes):
                boxes = boxes * r
                boxes[:, [0, 2]] += dw
                boxes[:, [1, 3]] += dh
        out_img, out_cls, out_box, out_mask = format_labels(img, cls, boxes, self.max_gt)
        return {"img": out_img, "cls": out_cls, "bboxes": out_box, "mask": out_mask}

    # --- the segment, pose and OBB tasks: instances with points -------------------------------------
    @property
    def nkpt(self) -> int:
        """The dataset's keypoint count (the most any row has), for one batch shape."""
        if not hasattr(self, "_nkpt"):
            self._nkpt = max((len(k) for kl in self.keypoints.values() for k in kl if k is not None), default=1)
        return self._nkpt

    def _task_payload(self, j: int, shape: Tuple[int, int], k: int):
        """(cls, boxes xyxy px, points (n, K, 2) px, visibility (n, K) or None) of image ``j`` at its
        pre-resized ``shape``: polygons resampled to ``k`` points (a box row's outline where a row
        has none), OBB corners (likewise), or keypoints (zeros where a row has none)."""
        h, w = shape
        cls, boxes = self.label_pixels(j, shape)
        n = len(cls)
        if self.task == "obb":
            corners = self.rcorners.get(j, [])
            pts = np.zeros((n, 4, 2), np.float32)
            for t in range(n):
                if t < len(corners) and corners[t] is not None:
                    pts[t] = corners[t] * np.asarray([w, h], np.float32)
                else:
                    x1, y1, x2, y2 = boxes[t]
                    pts[t] = [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]
            return cls, boxes, pts, None
        if self.task == "segment":
            polys = self.segments.get(j, [None] * n)
            pts = np.zeros((n, k, 2), np.float32)
            for t in range(n):
                poly = polys[t] if t < len(polys) else None
                if poly is None:
                    x1, y1, x2, y2 = boxes[t]
                    poly = np.asarray([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float32)
                else:
                    poly = poly * np.asarray([w, h], np.float32)
                pts[t] = resample_poly(poly, k)
            return cls, boxes, pts, None
        kl = self.keypoints.get(j, [])
        pts = np.zeros((n, self.nkpt, 2), np.float32)
        vis = np.zeros((n, self.nkpt), np.float32)
        for t in range(n):
            kp = kl[t] if t < len(kl) else None
            if kp is not None:
                pts[t, : len(kp), 0] = kp[:, 0] * w
                pts[t, : len(kp), 1] = kp[:, 1] * h
                vis[t, : len(kp)] = kp[:, 2]
        return cls, boxes, pts, vis

    def _rasterize_overlap(self, pts, imgsz: int):
        """(masks (imgsz / mask_ratio)^2 int32, order): each polygon filled at mask size, instances
        ranked by filled area, largest first, so a smaller one overwrites a larger one; pixel value
        rank + 1. The caller reorders its instances by ``order``."""
        ms = imgsz // self.mask_ratio
        scale = ms / imgsz
        n = len(pts)
        per = np.zeros((n, ms, ms), np.uint8)
        for t in range(n):
            cv.fill_poly(per[t], [(np.asarray(pts[t], np.float32) * scale).astype(np.int32)], 1)
        areas = per.reshape(n, -1).sum(-1) if n else np.zeros((0,))
        order = np.argsort(-areas, kind="stable")
        masks = np.zeros((ms, ms), np.int32)
        for rank, idx in enumerate(order):
            masks[per[idx] > 0] = rank + 1
        return masks, order

    def _aug_task_sample(self, i: int, rng: np.random.Generator, mosaic: bool) -> Dict:
        """A training sample with points: mosaic, affine and flips carry the polygons or keypoints
        (``train_transform_task``), then the masks are filled from the warped polygons."""
        kind = self.task
        k = self.POLY_PTS if kind == "segment" else 4
        flip_idx = self.flip_idx if kind == "pose" else None
        use_mosaic = mosaic and rng.random() < self.hyp.get("mosaic", 1.0)
        idxs = [i] + (list(rng.integers(0, len(self), 3)) if use_mosaic else [])
        imgs = [self.load_image(j) for j in idxs]
        labels = [self._task_payload(j, imgs[t].shape[:2], k) for t, j in enumerate(idxs)]
        img, cls, boxes, pts, vis = train_transform_task(imgs, labels, self.imgsz, rng, self.hyp, mosaic=use_mosaic,
                                                         kind=kind, flip_idx=flip_idx)
        if use_mosaic and rng.random() < self.hyp.get("mixup", 0.0):
            idxs2 = list(rng.integers(0, len(self), 4))
            imgs2 = [self.load_image(j) for j in idxs2]
            labels2 = [self._task_payload(j, imgs2[t].shape[:2], k) for t, j in enumerate(idxs2)]
            img2, *labels2 = train_transform_task(imgs2, labels2, self.imgsz, rng, self.hyp, mosaic=True, kind=kind,
                                                  flip_idx=flip_idx)
            img, cls, boxes, pts, vis = mixup_task(img, (cls, boxes, pts, vis), img2, labels2, rng)
        if self.hyp.get("bgr", 0.0) and rng.random() < self.hyp.get("bgr", 0.0):
            img = np.ascontiguousarray(img[..., ::-1])
        # truncated to max_gt before the task's encoding, so mask values and keypoint rows match the label slots
        cls, boxes, pts = cls[: self.max_gt], boxes[: self.max_gt], pts[: self.max_gt]
        vis = None if vis is None else vis[: self.max_gt]
        out: Dict = {}
        if kind == "segment":
            masks, order = self._rasterize_overlap(pts, self.imgsz)
            cls, boxes = cls[order], boxes[order]
            out["masks"] = masks
        elif kind == "obb":  # the rectangle fitted again around the warped corners
            out_rb = np.zeros((self.max_gt, 5), np.float32)
            for t in range(len(pts)):
                rb = _rbox_from_corners(pts[t])
                out_rb[t] = [rb[0] / self.imgsz, rb[1] / self.imgsz, rb[2] / self.imgsz, rb[3] / self.imgsz, rb[4]]
            out["rboxes"] = out_rb
        else:
            out_kpts = np.zeros((self.max_gt, pts.shape[1], 3), np.float32)
            if len(pts):
                out_kpts[: len(pts), :, :2] = pts / self.imgsz
                out_kpts[: len(pts), :, 2] = vis
            out["keypoints"] = out_kpts
        out_img, out_cls, out_box, out_mask = format_labels(img, cls, boxes, self.max_gt)
        out.update({"img": out_img, "cls": out_cls, "bboxes": out_box, "mask": out_mask})
        return out

    def _val_task_sample(self, i: int, shape: Optional[Tuple[int, int]] = None) -> Dict:
        """A validation sample with points: letterboxed without enlarging; segment polygons (a box row's
        outline where a row has none) filled at mask size, pose keypoints normalized to the canvas."""
        im = self.load_image(i)
        h, w = im.shape[:2]
        cls, boxes = self.label_pixels(i, (h, w))
        img, r, (dw, dh) = letterbox_image(im, shape or (self.imgsz, self.imgsz), scaleup=False)
        th, tw = img.shape[:2]
        if len(boxes):
            boxes = boxes * r
            boxes[:, [0, 2]] += dw
            boxes[:, [1, 3]] += dh
        out: Dict = {}
        if self.task == "segment":
            polys = self.segments.get(i, [None] * len(cls))
            n = min(len(cls), self.max_gt)
            pts = []
            for j in range(n):
                poly = polys[j] if j < len(polys) else None
                if poly is None:
                    x1, y1, x2, y2 = boxes[j]
                    poly = np.asarray([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float32)
                else:
                    poly = poly * [w, h] * r + [dw, dh]
                pts.append(np.asarray(poly, np.float32))
            # filled on a square canvas of the longer side: the rest is padding
            masks, order = self._rasterize_overlap(pts, max(th, tw))
            out["masks"] = masks[: th // self.mask_ratio, : tw // self.mask_ratio]
            if n:
                cls, boxes = cls[:n][order], boxes[:n][order]
        else:
            out_kpts = np.zeros((self.max_gt, self.nkpt, 3), np.float32)
            for j, kp in enumerate(self.keypoints.get(i, [])[: self.max_gt]):
                if kp is None:
                    continue
                kk = kp.copy()
                kk[:, 0] = (kk[:, 0] * w * r + dw) / tw
                kk[:, 1] = (kk[:, 1] * h * r + dh) / th
                out_kpts[j, : len(kk)] = kk
            out["keypoints"] = out_kpts
        out_img, out_cls, out_box, out_mask = format_labels(img, cls, boxes, self.max_gt)
        out.update({"img": out_img, "cls": out_cls, "bboxes": out_box, "mask": out_mask})
        return out

    def _val_obb_sample(self, i: int, shape: Optional[Tuple[int, int]] = None) -> Dict:
        """A validation OBB sample: letterboxed without enlarging, each rotated box's centre and size
        mapped onto the canvas (the angle kept); a box row is its axis-aligned box at angle 0."""
        im = self.load_image(i)
        h, w = im.shape[:2]
        cls, boxes = self.label_pixels(i, (h, w))
        img, r, (dw, dh) = letterbox_image(im, shape or (self.imgsz, self.imgsz), scaleup=False)
        th, tw = img.shape[:2]
        if len(boxes):
            boxes = boxes * r
            boxes[:, [0, 2]] += dw
            boxes[:, [1, 3]] += dh
        out_rb = np.zeros((self.max_gt, 5), np.float32)
        for j, rb in enumerate(self.rboxes.get(i, [])[: self.max_gt]):
            if rb is None:
                x1, y1, x2, y2 = boxes[j]
                out_rb[j] = [(x1 + x2) / 2 / tw, (y1 + y2) / 2 / th, (x2 - x1) / tw, (y2 - y1) / th, 0.0]
            else:
                out_rb[j] = [(rb[0] * w * r + dw) / tw, (rb[1] * h * r + dh) / th, rb[2] * w * r / tw,
                             rb[3] * h * r / th, rb[4]]
        out_img, out_cls, out_box, out_mask = format_labels(img, cls, boxes, self.max_gt)
        return {"img": out_img, "cls": out_cls, "bboxes": out_box, "mask": out_mask, "rboxes": out_rb}
