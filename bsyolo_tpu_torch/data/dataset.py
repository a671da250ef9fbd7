"""YOLO-format detection dataset (counterpart of the detect part of ``bsyolo_tpu/data/dataset.py``).

A dataset YAML (path / train / val / names) names image folders or lists;
each image's labels are the sibling ``labels/<stem>.txt`` rows ``class cx cy
w h`` (normalized). Images are read by ``data/imread.py`` (PNG, BMP and .npy
without OpenCV) and pre-resized by ``data/cv.py``. The parsed labels are
cached in ``labels.cache.npz`` beside the label folder in the JAX package's
format and hash, so both packages share one cache.
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
from bsyolo_tpu_torch.data.augment import format_labels, mixup, train_transform
from bsyolo_tpu_torch.data.imread import image_size, imread
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


def img2label_path(img_path: str) -> str:
    """images/xxx.jpg -> labels/xxx.txt."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(img_path.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


class YOLODataset:
    """Detection dataset: file listing, labels and the augment and letterbox paths of one sample."""

    def __init__(self, img_path, imgsz: int = 640, augment: bool = True, hyp: Optional[Dict] = None,
                 max_gt: int = 128, single_cls: bool = False, fraction: float = 1.0, task: str = "detect",
                 cache: object = False):
        if task != "detect":
            raise NotImplementedError(f"task {task!r} datasets are not ported yet (ROADMAP queue 1, item 12)")
        self.task = task
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
            np.savez(self._cache_path(), hash=self._cache_hash(), labels=obj(self.labels), segments=obj({}),
                     keypoints=obj({}), rboxes=obj({}), rcorners=obj({}), allow_pickle=True)
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
        """(cls (n,), normalized xywh (n, 4) clipped to [0, 1]) from the label file's rows of 5 or more."""
        lp = self.label_files[i]
        if not os.path.exists(lp):
            return np.zeros((0,), np.float32), np.zeros((0, 4), np.float32)
        rows = [[float(x) for x in parts[:5]] for parts in (line.split() for line in Path(lp).read_text().splitlines())
                if len(parts) >= 5]
        if not rows:
            return np.zeros((0,), np.float32), np.zeros((0, 4), np.float32)
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
        """One sample: img (uint8 RGB HWC), cls, bboxes (normalized xywh), mask, padded to max_gt.
        ``shape``: the letterbox canvas of a rect val bucket, in place of the square."""
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
