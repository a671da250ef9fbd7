"""DOTA aerial-image tiling (counterpart of ``bsyolo_tpu/data/split_dota.py``).

Splits large aerial images and their 8-point polygon labels into overlapping
crop_size windows, keeping the objects whose polygon lies inside a window by
IoF >= thr. The polygon-window intersection is Sutherland-Hodgman clipping
against the axis-aligned window and the shoelace area, batched in numpy over
all polygons. Images are read by ``data/imread.py`` (a file it cannot decode
is skipped) and the crops written by its JPEG encoder (``imwrite``, the bytes
OpenCV writes), so no OpenCV is needed.
"""

from __future__ import annotations

import itertools
from math import ceil
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def _clip_batch_halfplane(poly: np.ndarray, cnt: np.ndarray, axis: int, value: float,
                          keep_less: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized Sutherland–Hodgman pass over N padded polygons.

    poly (N, V, 2) with cnt (N,) valid vertices; returns (N, V+1, 2) + new
    counts. Each convex clip adds at most one vertex. All arithmetic is
    batched numpy — no per-polygon Python loop (a real DOTA image has
    thousands of instances x dozens of windows)."""
    N, V, _ = poly.shape
    idx = np.arange(V)[None, :]
    valid = idx < cnt[:, None]
    nxt_idx = np.where(idx + 1 < cnt[:, None], idx + 1, 0)
    cur = poly
    nxt = np.take_along_axis(poly, nxt_idx[..., None].repeat(2, -1), axis=1)
    a = cur[..., axis]
    b = nxt[..., axis]
    cin = (a <= value) if keep_less else (a >= value)
    nin = (b <= value) if keep_less else (b >= value)
    t = (value - a) / (b - a + 1e-12)
    inter = cur + t[..., None] * (nxt - cur)
    # each edge emits up to 2 points: cur (if inside) then intersection (if
    # crossing); compact with a prefix-sum scatter (trash column V+1 absorbs
    # masked writes, then gets sliced off)
    emit_cur = valid & cin
    emit_int = valid & (cin != nin)
    n_emit = emit_cur.astype(np.int64) + emit_int.astype(np.int64)
    offs = np.cumsum(n_emit, axis=1) - n_emit
    out = np.zeros((N, V + 2, 2), np.float64)
    trash = V + 1
    pos_cur = np.where(emit_cur, offs, trash)
    np.put_along_axis(out, pos_cur[..., None].repeat(2, -1), cur, axis=1)
    pos_int = np.where(emit_int, offs + emit_cur.astype(np.int64), trash)
    np.put_along_axis(out, pos_int[..., None].repeat(2, -1), inter, axis=1)
    return out[:, : V + 1], n_emit.sum(axis=1)


def _poly_area_batch(poly: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Shoelace area over N padded polygons (N, V, 2) with counts (N,)."""
    N, V, _ = poly.shape
    idx = np.arange(V)[None, :]
    valid = idx < cnt[:, None]
    nxt_idx = np.where(idx + 1 < cnt[:, None], idx + 1, 0)
    nxt = np.take_along_axis(poly, nxt_idx[..., None].repeat(2, -1), axis=1)
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    s = np.where(valid, cross, 0.0).sum(axis=1)
    return np.where(cnt >= 3, 0.5 * np.abs(s), 0.0)


def bbox_iof(polygon1: np.ndarray, bbox2: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """IoF of polygons (n, 8) vs axis-aligned boxes (m, 4) -> (n, m)
    (reference split_dota.py:17; shapely replaced by a BATCHED numpy
    rect-clip — vectorized over all polygons, looping only over windows)."""
    polys = polygon1.reshape(-1, 4, 2).astype(np.float64)
    N = len(polys)
    cnt0 = np.full(N, 4, np.int64)
    areas = np.maximum(_poly_area_batch(polys, cnt0), eps)
    out = np.zeros((N, len(bbox2)))
    for j, (x1, y1, x2, y2) in enumerate(np.asarray(bbox2, np.float64)):
        p, c = polys, cnt0
        p, c = _clip_batch_halfplane(p, c, 0, x1, keep_less=False)
        p, c = _clip_batch_halfplane(p, c, 0, x2, keep_less=True)
        p, c = _clip_batch_halfplane(p, c, 1, y1, keep_less=False)
        p, c = _clip_batch_halfplane(p, c, 1, y2, keep_less=True)
        out[:, j] = _poly_area_batch(p, c) / areas
    return out


def get_windows(
    im_size: Tuple[int, int],
    crop_sizes: Sequence[int] = (1024,),
    gaps: Sequence[int] = (200,),
    im_rate_thr: float = 0.6,
    eps: float = 0.01,
) -> np.ndarray:
    """Sliding-window rects (N, 4) xyxy covering the image
    (reference split_dota.py:97)."""
    h, w = im_size
    windows = []
    for crop_size, gap in zip(crop_sizes, gaps):
        assert crop_size > gap, f"invalid crop_size gap pair [{crop_size} {gap}]"
        step = crop_size - gap
        xn = 1 if w <= crop_size else ceil((w - crop_size) / step + 1)
        xs = [step * i for i in range(xn)]
        if len(xs) > 1 and xs[-1] + crop_size > w:
            xs[-1] = w - crop_size
        yn = 1 if h <= crop_size else ceil((h - crop_size) / step + 1)
        ys = [step * i for i in range(yn)]
        if len(ys) > 1 and ys[-1] + crop_size > h:
            ys[-1] = h - crop_size
        start = np.asarray(list(itertools.product(xs, ys)), np.int64)
        stop = start + crop_size
        windows.append(np.concatenate([start, stop], axis=1))
    windows = np.concatenate(windows, axis=0)
    # keep windows that mostly overlap the image (reference im_rate_thr)
    clipped = windows.copy()
    clipped[:, 0::2] = clipped[:, 0::2].clip(0, w)
    clipped[:, 1::2] = clipped[:, 1::2].clip(0, h)
    im_areas = (clipped[:, 2] - clipped[:, 0]) * (clipped[:, 3] - clipped[:, 1])
    win_areas = (windows[:, 2] - windows[:, 0]) * (windows[:, 3] - windows[:, 1])
    rates = im_areas / win_areas
    if not (rates > im_rate_thr).any():
        rates[rates == rates.max()] = 1.0
    return windows[rates > im_rate_thr]


def get_window_obj(label: np.ndarray, windows: np.ndarray, iof_thr: float = 0.7) -> List[np.ndarray]:
    """Per-window label subsets; label rows are (cls, x1..y4) normalized-free
    pixels (reference split_dota.py:141)."""
    if len(label):
        iofs = bbox_iof(label[:, 1:], windows)
        return [label[iofs[:, i] >= iof_thr] for i in range(len(windows))]
    return [np.zeros((0, 9), np.float32) for _ in range(len(windows))]


def split_image(
    img: np.ndarray,
    label: np.ndarray,
    crop_sizes: Sequence[int] = (1024,),
    gaps: Sequence[int] = (200,),
    iof_thr: float = 0.7,
    allow_background: bool = True,
) -> List[Tuple[np.ndarray, np.ndarray, Tuple[int, int]]]:
    """One image -> [(crop, crop_label, (x0, y0)), ...]; crop labels keep the
    (cls, 8-point) layout shifted into window coords."""
    h, w = img.shape[:2]
    windows = get_windows((h, w), crop_sizes, gaps)
    per_win = get_window_obj(label, windows, iof_thr)
    out = []
    for win, lb in zip(windows, per_win):
        if len(lb) == 0 and not allow_background:
            continue
        x1, y1, x2, y2 = map(int, win)
        crop = img[max(y1, 0) : y2, max(x1, 0) : x2]
        ph, pw = (y2 - y1) - crop.shape[0], (x2 - x1) - crop.shape[1]
        if ph > 0 or pw > 0:
            crop = np.pad(crop, ((0, ph), (0, pw), (0, 0)))
        lb = lb.copy()
        if len(lb):
            lb[:, 1::2] -= x1
            lb[:, 2::2] -= y1
        out.append((crop, lb, (x1, y1)))
    return out


def split_images_and_labels(
    data_root: str,
    save_dir: str,
    split: str = "train",
    crop_sizes: Sequence[int] = (1024,),
    gaps: Sequence[int] = (200,),
):
    """Whole-directory split (reference split_dota.py:200): images/<split> +
    labels/<split> with DOTA 8-point rows -> cropped dataset under save_dir."""
    from bsyolo_tpu_torch.data.dataset import img2label_path
    from bsyolo_tpu_torch.data.imread import imread, imwrite
    from bsyolo_tpu_torch.data.jpeg import ImageFormatError

    im_dir = Path(data_root) / "images" / split
    out_im = Path(save_dir) / "images" / split
    out_lb = Path(save_dir) / "labels" / split
    out_im.mkdir(parents=True, exist_ok=True)
    out_lb.mkdir(parents=True, exist_ok=True)
    n = 0
    for im_file in sorted(im_dir.glob("*")):
        try:
            img = imread(im_file)
        except ImageFormatError:
            img = None
        if img is None:
            continue
        lb_file = Path(img2label_path(str(im_file)))
        label = np.zeros((0, 9), np.float32)
        if lb_file.exists():
            rows = [x.split() for x in lb_file.read_text().strip().splitlines() if x]
            if rows:
                label = np.asarray(rows, np.float32)
        for crop, lb, (x0, y0) in split_image(img, label, crop_sizes, gaps):
            stem = f"{im_file.stem}__{crop.shape[1]}__{x0}___{y0}"
            imwrite(out_im / f"{stem}.jpg", np.ascontiguousarray(crop))
            lines = [" ".join(f"{v:.6g}" for v in row) for row in lb]
            (out_lb / f"{stem}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
            n += 1
    return n


def split_trainval(data_root: str, save_dir: str, crop_size: int = 1024, gap: int = 200,
                   rates: Sequence[float] = (1.0,)):
    """Split train + val at one or more scales (reference split_dota.py:230)."""
    crop_sizes = [int(crop_size / r) for r in rates]
    gaps = [int(gap / r) for r in rates]
    total = 0
    for split in ("train", "val"):
        if (Path(data_root) / "images" / split).exists():
            total += split_images_and_labels(data_root, save_dir, split, crop_sizes, gaps)
    return total
