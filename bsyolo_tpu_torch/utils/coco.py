"""COCO-format results and their evaluation (counterpart of the detect, segment, pose and OBB parts
of ``bsyolo_tpu/utils/coco.py``).

``pred_to_json``, ``seg_pred_to_json`` (masks as compressed RLE,
``encode_rle``/``decode_rle``, no pycocotools), ``pose_pred_to_json`` and
``save_predictions_json`` write the standard COCO results format; ``evaluate_json`` scores a predictions file against an
annotation file with a self-contained evaluator built on
``utils/metrics.py`` (per-image greedy matching at IoU 0.50:0.95, 101-point
AP). It never calls pycocotools, which the JAX package prefers where it is
installed, and scores boxes only. ``obb_pred_to_json`` writes rotated boxes with
both their ``rbox`` (cx, cy, w, h, r) and their corners (``poly``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from bsyolo_tpu_torch.utils.metrics import ap_per_class, match_predictions

# COCO's category ids are sparse 1..90; the model's classes are dense 0..79
COCO80_TO_COCO91 = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
    46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88,
    89, 90,
]


def pred_to_json(dets: np.ndarray, filename: str, class_map: Optional[List[int]] = None) -> List[Dict]:
    """(n, 6) x1, y1, x2, y2, conf, cls rows of one image -> COCO result dicts; the image id is the
    file stem, an int where the stem is numeric."""
    stem = Path(filename).stem
    image_id = int(stem) if stem.isnumeric() else stem
    out = []
    for x1, y1, x2, y2, conf, cls in np.asarray(dets, np.float64):
        if conf <= 0:
            continue
        c = int(cls)
        out.append({
            "image_id": image_id,
            "category_id": class_map[c] if class_map else c,
            "bbox": [round(x1, 3), round(y1, 3), round(x2 - x1, 3), round(y2 - y1, 3)],
            "score": round(float(conf), 5),
        })
    return out


def encode_rle(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> COCO compressed RLE, the bytes ``pycocotools.mask.encode`` gives:
    column-major run lengths starting with the zero run, each from the third on coded as its
    difference to the one two before, packed 5 bits per character (offset 48, 0x20 marks that
    more follow)."""
    h, w = mask.shape
    pixels = np.asarray(mask, np.uint8).flatten(order="F")
    change = np.flatnonzero(pixels[1:] != pixels[:-1]) + 1
    counts = np.diff(np.concatenate([[0], change, [pixels.size]])).tolist()
    if pixels.size and pixels[0] == 1:
        counts = [0] + counts  # the counts start with a run of zeros
    if not pixels.size:
        counts = [0]
    s = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5  # arithmetic, as C's signed shift
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
    return {"size": [int(h), int(w)], "counts": "".join(s)}


def decode_rle(rle: Dict) -> np.ndarray:
    """COCO compressed RLE -> binary (H, W) uint8 mask."""
    h, w = rle["size"]
    s = rle["counts"]
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    vals = np.zeros(sum(counts), np.uint8)
    pos, v = 0, 0
    for c in counts:
        vals[pos : pos + c] = v
        pos += c
        v = 1 - v
    return vals.reshape((w, h)).T  # column-major


def seg_pred_to_json(dets: np.ndarray, masks: np.ndarray, filename: str,
                     class_map: Optional[List[int]] = None) -> List[Dict]:
    """(n, 6) rows and (n, H0, W0) binary masks of one image, in its original pixels -> COCO
    segmentation results (``pred_to_json``'s dicts with the mask as compressed RLE)."""
    out = pred_to_json(dets, filename, class_map=class_map)
    kept = [i for i, d in enumerate(np.asarray(dets, np.float64)) if d[4] > 0]
    for rec, i in zip(out, kept):
        rec["segmentation"] = encode_rle(np.asarray(masks[i]) > 0.5)
    return out


def pose_pred_to_json(dets: np.ndarray, kpts: np.ndarray, filename: str,
                      class_map: Optional[List[int]] = None) -> List[Dict]:
    """(n, 6) rows and (n, K, 2 or 3) keypoints of one image, in its original pixels -> COCO keypoint
    results (``pred_to_json``'s dicts with ``keypoints`` x, y, v to 3 decimals; v is 2 where the
    keypoints carry none)."""
    out = pred_to_json(dets, filename, class_map=class_map)
    kept = [i for i, d in enumerate(np.asarray(dets, np.float64)) if d[4] > 0]
    for rec, i in zip(out, kept):
        k = np.asarray(kpts[i], np.float64)
        if k.shape[-1] == 2:
            k = np.concatenate([k, np.full((*k.shape[:-1], 1), 2.0)], axis=-1)
        rec["keypoints"] = [round(float(v), 3) for v in k.reshape(-1)]
    return out


def save_predictions_json(jdict: List[Dict], path) -> str:
    Path(path).write_text(json.dumps(jdict))
    return str(path)


def _box_iou_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, 4) x (N, 4) COCO xywh boxes -> (M, N) IoU."""
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.minimum(ax2[:, None], bx2[None]) - np.maximum(a[:, 0][:, None], b[:, 0][None])
    ih = np.minimum(ay2[:, None], by2[None]) - np.maximum(a[:, 1][:, None], b[:, 1][None])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    ua = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return np.where(ua > 0, inter / np.where(ua > 0, ua, 1.0), 0.0)


def evaluate_json(anno_json, pred_json, verbose: bool = True) -> Dict[str, float]:
    """mAP50-95 and mAP50 of a COCO results file against a COCO annotation file (or a bare list of
    annotations): each image's predictions, highest score first, matched greedily to its ground
    truths at the 10 IoU thresholds, then 101-point AP per class, averaged."""
    anno = json.loads(Path(anno_json).read_text())
    preds = json.loads(Path(pred_json).read_text())
    gt_by_img: Dict = {}
    for a in anno["annotations"] if isinstance(anno, dict) else anno:
        gt_by_img.setdefault(a["image_id"], []).append(a)
    pr_by_img: Dict = {}
    for p in preds:
        pr_by_img.setdefault(p["image_id"], []).append(p)

    iouv = np.linspace(0.5, 0.95, 10)
    tps, confs, pcls, tcls = [], [], [], []
    for img_id in set(gt_by_img) | set(pr_by_img):
        gts = gt_by_img.get(img_id, [])
        prs = sorted(pr_by_img.get(img_id, []), key=lambda p: -p["score"])
        gt_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        gt_cls = np.asarray([g["category_id"] for g in gts], np.float64)
        tcls.append(gt_cls)
        if not prs:
            continue
        pr_boxes = np.asarray([p["bbox"] for p in prs], np.float64).reshape(-1, 4)
        pr_cls = np.asarray([p["category_id"] for p in prs], np.float64)
        iou = _box_iou_xywh(gt_boxes, pr_boxes) if len(gts) else np.zeros((0, len(prs)))
        tps.append(match_predictions(pr_cls, gt_cls, iou, iouv))
        confs.append(np.asarray([p["score"] for p in prs], np.float64))
        pcls.append(pr_cls)
    if not tps:
        return {"mAP50-95": 0.0, "mAP50": 0.0}
    ap = ap_per_class(np.concatenate(tps), np.concatenate(confs), np.concatenate(pcls), np.concatenate(tcls))[5]
    out = {"mAP50-95": float(ap.mean()), "mAP50": float(ap[:, 0].mean())}
    if verbose:
        print(f"COCO-json eval (built-in): mAP50-95 {out['mAP50-95']:.4f}  mAP50 {out['mAP50']:.4f}")
    return out


def obb_pred_to_json(dets: np.ndarray, filename: str, class_map: Optional[List[int]] = None) -> List[Dict]:
    """(n, 7) rotated rows (x, y, w, h, conf, cls, angle) of one image -> COCO-style dicts with ``rbox``
    (cx, cy, w, h, r) and ``poly`` (the 8 corner coordinates), rounded to 3 decimals; rows of conf 0 are
    skipped."""
    import torch

    from bsyolo_tpu_torch.ops.obb import xywhr2xyxyxyxy

    stem = Path(filename).stem
    image_id = int(stem) if stem.isnumeric() else stem
    d = np.asarray(dets, np.float64)
    if not len(d):
        return []
    rbox = np.concatenate([d[:, :4], d[:, 6:7]], -1)
    poly = xywhr2xyxyxyxy(torch.from_numpy(rbox.astype(np.float32))).numpy().reshape(len(d), 8)
    return [{"image_id": image_id, "category_id": class_map[int(row[5])] if class_map else int(row[5]),
             "score": round(float(row[4]), 5), "rbox": [round(float(x), 3) for x in rbox[i]],
             "poly": [round(float(x), 3) for x in poly[i]]}
            for i, row in enumerate(d) if row[4] > 0]
