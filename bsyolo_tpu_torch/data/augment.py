"""Host-side training augmentations of the detect path (counterpart of the detect part of
``bsyolo_tpu/data/augment.py``).

Mosaic (4 or 9) -> random perspective (letterbox first without mosaic) ->
copy-paste -> photometric suite -> HSV -> flips, on uint8 BGR numpy images,
with the pixel operations of ``data/cv.py``. The label math is the JAX
package's, in its dtypes (float32 matrices and boxes, float64 draws), and
every random draw is taken in the same order from the caller's
``np.random.Generator``, so that labels come out bit-identical to the JAX
package's for the same generator state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from bsyolo_tpu_torch.data import cv
from bsyolo_tpu_torch.data.photometric import photometric_suite
from bsyolo_tpu_torch.ops.letterbox import letterbox_image


def random_hsv(img: np.ndarray, rng: np.random.Generator, hgain=0.015, sgain=0.7, vgain=0.4):
    """HSV jitter through per-channel lookup tables."""
    if hgain or sgain or vgain:
        r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
        hsv = cv.bgr2hsv(img)
        dtype = img.dtype
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(dtype)
        lut_sat = np.clip(x * r[1], 0, 255).astype(dtype)
        lut_val = np.clip(x * r[2], 0, 255).astype(dtype)
        im_hsv = np.stack([cv.lut(hsv[..., 0], lut_hue), cv.lut(hsv[..., 1], lut_sat), cv.lut(hsv[..., 2], lut_val)],
                          -1)
        img = cv.hsv2bgr(im_hsv)
    return img


def random_flip(img, boxes_xyxy, rng, fliplr=0.5, flipud=0.0):
    """Vertical, then horizontal flip, each with its probability; boxes follow."""
    h, w = img.shape[:2]
    if flipud and rng.random() < flipud:
        img = np.flipud(img)
        y1 = boxes_xyxy[:, 1].copy()
        boxes_xyxy[:, 1] = h - boxes_xyxy[:, 3]
        boxes_xyxy[:, 3] = h - y1
    if fliplr and rng.random() < fliplr:
        img = np.fliplr(img)
        x1 = boxes_xyxy[:, 0].copy()
        boxes_xyxy[:, 0] = w - boxes_xyxy[:, 2]
        boxes_xyxy[:, 2] = w - x1
    return np.ascontiguousarray(img), boxes_xyxy


def mosaic4(images: List[np.ndarray], labels: List[Tuple], imgsz: int, rng: np.random.Generator):
    """4-way mosaic on a 2x canvas around a random centre. Returns (img, cls, boxes, border)."""
    s = imgsz
    border = (-s // 2, -s // 2)
    yc = int(rng.uniform(-border[0], 2 * s + border[0]))
    xc = int(rng.uniform(-border[1], 2 * s + border[1]))
    img4 = np.full((s * 2, s * 2, images[0].shape[2]), 114, dtype=np.uint8)
    out_cls, out_boxes = [], []
    for i in range(4):
        img = images[i]
        h, w = img.shape[:2]
        if i == 0:  # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        cls, boxes = labels[i][0], labels[i][1]
        if len(boxes):
            b = boxes.copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            out_cls.append(cls)
            out_boxes.append(b)
    cls = np.concatenate(out_cls) if out_cls else np.zeros((0,), np.float32)
    boxes = np.concatenate(out_boxes) if out_boxes else np.zeros((0, 4), np.float32)
    return img4, cls, np.clip(boxes, 0, 2 * s), border


def mosaic9(images: List[np.ndarray], labels: List[Tuple], imgsz: int, rng: np.random.Generator):
    """9-way mosaic on a 3x canvas, a random 2x window of it. Returns (img, cls, boxes, border)."""
    s = imgsz
    canvas = np.full((s * 3, s * 3, images[0].shape[2]), 114, dtype=np.uint8)
    out_cls, out_boxes = [], []
    h0 = w0 = 0  # centre image
    hp = wp = 0  # previous image
    for i in range(9):
        img = images[i]
        h, w = img.shape[:2]
        if i == 0:  # center
            h0, w0 = h, w
            c = (s, s, s + w, s + h)
        elif i == 1:  # top
            c = (s, s - h, s + w, s)
        elif i == 2:  # top right
            c = (s + wp, s - h, s + wp + w, s)
        elif i == 3:  # right
            c = (s + w0, s, s + w0 + w, s + h)
        elif i == 4:  # bottom right
            c = (s + w0, s + hp, s + w0 + w, s + hp + h)
        elif i == 5:  # bottom
            c = (s + w0 - w, s + h0, s + w0, s + h0 + h)
        elif i == 6:  # bottom left
            c = (s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h)
        elif i == 7:  # left
            c = (s - w, s + h0 - h, s, s + h0)
        else:  # top left
            c = (s - w, s + h0 - hp - h, s, s + h0 - hp)
        x1, y1 = (max(v, 0) for v in c[:2])
        x2, y2 = min(c[2], 3 * s), min(c[3], 3 * s)
        if x2 > x1 and y2 > y1:
            canvas[y1:y2, x1:x2] = img[(y1 - c[1]) : (y1 - c[1]) + (y2 - y1), (x1 - c[0]) : (x1 - c[0]) + (x2 - x1)]
            cls, boxes = labels[i][0], labels[i][1]
            if len(boxes):
                b = boxes.copy()
                b[:, [0, 2]] += c[0]
                b[:, [1, 3]] += c[1]
                out_cls.append(cls)
                out_boxes.append(b)
        hp, wp = h, w
    yc = int(rng.uniform(0, s))
    xc = int(rng.uniform(0, s))
    canvas = canvas[yc : yc + 2 * s, xc : xc + 2 * s]
    cls = np.concatenate(out_cls) if out_cls else np.zeros((0,), np.float32)
    boxes = np.concatenate(out_boxes) if out_boxes else np.zeros((0, 4), np.float32)
    if len(boxes):
        boxes[:, [0, 2]] -= xc
        boxes[:, [1, 3]] -= yc
        boxes = np.clip(boxes, 0, 2 * s)
        keep = ((boxes[:, 2] - boxes[:, 0]) > 2) & ((boxes[:, 3] - boxes[:, 1]) > 2)
        cls, boxes = cls[keep], boxes[keep]
    return canvas, cls, boxes, (-s // 2, -s // 2)


def mixup(img1, labels1, img2, labels2, rng: np.random.Generator):
    """Beta(32, 32) blend of two images and the union of their labels."""
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)).astype(img1.dtype)
    return img, np.concatenate([labels1[0], labels2[0]]), np.concatenate([labels1[1], labels2[1]])


def _ioa_too_high(cur, x1, y1, x2, y2) -> bool:
    iw = np.minimum(cur[:, 2], x2) - np.maximum(cur[:, 0], x1)
    ih = np.minimum(cur[:, 3], y2) - np.maximum(cur[:, 1], y1)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area = (cur[:, 2] - cur[:, 0]) * (cur[:, 3] - cur[:, 1]) + 1e-9
    return bool((inter / area >= 0.30).any())


def copy_paste(img, cls, boxes, rng: np.random.Generator, p: float = 0.5, donor=None):
    """Copy-paste: mirror a share of the image's boxes (donor None), or paste box regions of
    ``donor = (img, cls, boxes)`` in place; each paste only where its intersection over every
    current box's area stays below 0.30."""
    if donor is not None:
        dimg, dcls, dboxes = donor
        if len(dboxes) == 0:
            return img, cls, boxes
        h, w = img.shape[:2]
        n = max(1, int(len(dboxes) * p))
        sel = rng.choice(len(dboxes), n, replace=False)
        new_cls, new_boxes = [cls] if len(cls) else [], [boxes] if len(boxes) else []
        img = img.copy()
        for j in sel:
            x1 = int(np.clip(dboxes[j, 0], 0, w - 1))
            y1 = int(np.clip(dboxes[j, 1], 0, h - 1))
            x2 = int(np.clip(dboxes[j, 2], 0, w))
            y2 = int(np.clip(dboxes[j, 3], 0, h))
            if x2 <= x1 or y2 <= y1:
                continue
            if new_boxes and _ioa_too_high(np.concatenate(new_boxes), x1, y1, x2, y2):
                continue
            img[y1:y2, x1:x2] = dimg[y1:y2, x1:x2]
            new_cls.append(np.asarray(dcls[j : j + 1]))
            new_boxes.append(np.asarray([[x1, y1, x2, y2]], np.float32))
        if not new_boxes:
            return img, cls, boxes
        return img, np.concatenate(new_cls), np.concatenate(new_boxes)
    if len(boxes) == 0 or p <= 0:
        return img, cls, boxes
    h, w = img.shape[:2]
    n = max(1, int(len(boxes) * p))
    sel = rng.choice(len(boxes), n, replace=False)
    new_cls, new_boxes = [cls], [boxes]
    img = img.copy()
    for j in sel:
        x1, y1, x2, y2 = (int(v) for v in boxes[j])
        mx1, mx2 = w - x2, w - x1
        if mx2 <= mx1 or x2 <= x1 or y2 <= y1:
            continue
        if _ioa_too_high(np.concatenate(new_boxes), mx1, y1, mx2, y2):
            continue
        img[y1:y2, mx1:mx2] = np.fliplr(img[y1:y2, x1:x2])
        new_cls.append(cls[j : j + 1])
        new_boxes.append(np.asarray([[mx1, y1, mx2, y2]], np.float32))
    return img, np.concatenate(new_cls), np.concatenate(new_boxes)


def random_perspective(img: np.ndarray, cls: np.ndarray, boxes_xyxy: np.ndarray, rng: np.random.Generator,
                       degrees=0.0, translate=0.1, scale=0.5, shear=0.0, perspective=0.0, border=(0, 0)):
    """Random affine (or perspective) warp of the image with a constant 114 border, the boxes
    through the same matrix, then the candidate filter. Returns (img, cls, boxes)."""
    size = (img.shape[1] + border[1] * 2, img.shape[0] + border[0] * 2)
    C = np.eye(3, dtype=np.float32)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3, dtype=np.float32)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3, dtype=np.float32)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv.rotation_matrix_2d((0, 0), a, s)
    S = np.eye(3, dtype=np.float32)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3, dtype=np.float32)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * size[0]
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * size[1]
    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv.warp_perspective(img, M, size, (114, 114, 114))
        else:
            img = cv.warp_affine(img, M[:2], size, (114, 114, 114))
    if len(boxes_xyxy):
        cls, boxes_xyxy = warp_instance_labels(cls, boxes_xyxy, M, s, size, perspective)
    return img, cls, boxes_xyxy


def warp_instance_labels(cls, boxes_xyxy, M, s, size, perspective):
    """The label side of ``random_perspective`` given its matrix M: each box's four corners
    through M, their extent clipped to the canvas, then the candidate filter (more than 2 px
    wide and high, more than 10 % of the scaled area kept, aspect below 100)."""
    n = len(boxes_xyxy)
    xy = np.ones((n * 4, 3), dtype=np.float32)
    xy[:, :2] = boxes_xyxy[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    xy = xy @ M.T
    xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, size[0])
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, size[1])
    w1 = boxes_xyxy[:, 2] - boxes_xyxy[:, 0]
    h1 = boxes_xyxy[:, 3] - boxes_xyxy[:, 1]
    w2 = new[:, 2] - new[:, 0]
    h2 = new[:, 3] - new[:, 1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    keep = (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 * s * s + 1e-16) > 0.1) & (ar < 100)
    return cls[keep], new[keep]


def train_transform(imgs: List[np.ndarray], labels: List[Tuple[np.ndarray, np.ndarray]], imgsz: int,
                    rng: np.random.Generator, hyp: Optional[Dict] = None, mosaic: bool = True):
    """The train-time pipeline for one output sample. Returns (img uint8 HWC BGR, cls (n,),
    boxes xyxy pixels (n, 4))."""
    hyp = hyp or {}
    if mosaic and len(imgs) >= 9 and rng.random() < hyp.get("mosaic9", 0.0):
        img, cls, boxes, border = mosaic9(imgs[:9], labels[:9], imgsz, rng)
    elif mosaic and len(imgs) >= 4:
        img, cls, boxes, border = mosaic4(imgs[:4], labels[:4], imgsz, rng)
    else:
        cls, boxes = labels[0]
        img, r, (dw, dh) = letterbox_image(imgs[0], (imgsz, imgsz), scaleup=True)
        boxes = boxes * r
        boxes[:, [0, 2]] += dw
        boxes[:, [1, 3]] += dh
        border = (0, 0)
    img, cls, boxes = random_perspective(
        img, cls, boxes, rng, degrees=hyp.get("degrees", 0.0), translate=hyp.get("translate", 0.1),
        scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0), perspective=hyp.get("perspective", 0.0),
        border=border)
    if hyp.get("copy_paste", 0.0) > 0 and rng.random() < hyp.get("copy_paste", 0.0):
        donor = None
        if str(hyp.get("copy_paste_mode", "flip")) == "mixup" and len(imgs) > 1:
            k = int(rng.integers(1, len(imgs)))
            dimg, (dcls, dboxes) = imgs[k], labels[k]
            dimg, r, (dw, dh) = letterbox_image(dimg, img.shape[:2], scaleup=True)
            dboxes = dboxes * r
            dboxes[:, [0, 2]] += dw
            dboxes[:, [1, 3]] += dh
            donor = (dimg, dcls, dboxes)
        img, cls, boxes = copy_paste(img, cls, boxes, rng, donor=donor)
    img = photometric_suite(img, rng, p=hyp.get("albumentations", 1.0))
    img = random_hsv(img, rng, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4))
    img, boxes = random_flip(img, boxes, rng, fliplr=hyp.get("fliplr", 0.5), flipud=hyp.get("flipud", 0.0))
    return img, cls, boxes


def format_labels(img: np.ndarray, cls: np.ndarray, boxes_xyxy: np.ndarray, max_gt: int):
    """Ragged labels -> fixed (max_gt,) arrays, boxes as normalized xywh; the image as uint8
    RGB (the step divides by 255 on the card). Returns (img, cls int32, bboxes, mask)."""
    h, w = img.shape[:2]
    n = min(len(cls), max_gt)
    out_cls = np.zeros((max_gt,), np.int32)
    out_box = np.zeros((max_gt, 4), np.float32)
    out_mask = np.zeros((max_gt,), np.float32)
    if n:
        b = boxes_xyxy[:n].astype(np.float32)
        cx = (b[:, 0] + b[:, 2]) / 2 / w
        cy = (b[:, 1] + b[:, 3]) / 2 / h
        bw = (b[:, 2] - b[:, 0]) / w
        bh = (b[:, 3] - b[:, 1]) / h
        out_box[:n] = np.stack([cx, cy, bw, bh], -1)
        out_cls[:n] = cls[:n].astype(np.int32)
        out_mask[:n] = 1.0
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    return np.ascontiguousarray(img[..., ::-1]), out_cls, out_box, out_mask
