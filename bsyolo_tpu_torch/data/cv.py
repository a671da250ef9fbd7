"""numpy counterparts of the OpenCV calls on the data paths.

The port's data pipeline runs where OpenCV may not be installed, so each cv2
call that ``bsyolo_tpu/data`` makes on the paths the port serves has a numpy version
here, on uint8 (h, w[, c]) images:

| function | replaces |
| --- | --- |
| ``resize`` | ``cv2.resize`` INTER_LINEAR and INTER_AREA |
| ``warp_affine``, ``warp_perspective`` | ``cv2.warpAffine`` / ``cv2.warpPerspective``, INTER_LINEAR, constant border |
| ``rotation_matrix_2d`` | ``cv2.getRotationMatrix2D`` |
| ``bgr2hsv``, ``hsv2bgr``, ``lut`` | ``cv2.cvtColor`` BGR2HSV / HSV2BGR (8-bit, H in [0, 180)), ``cv2.LUT`` |
| ``blur``, ``median_blur`` | ``cv2.blur`` (BORDER_REFLECT_101), ``cv2.medianBlur`` (BORDER_REPLICATE) |
| ``gaussian_blur5``, ``equalize_hist`` | ``cv2.GaussianBlur(img, (5, 5), 0)``, ``cv2.equalizeHist`` |
| ``convex_hull``, ``min_area_rect`` | ``cv2.convexHull``, ``cv2.minAreaRect`` (float32 points) |
| ``rgb2gray`` | ``cv2.cvtColor`` RGB2GRAY (OpenCV's 15-bit fixed-point weights) |
| ``clahe`` | ``cv2.createCLAHE(...).apply`` on the L channel of ``cv2.cvtColor`` RGB2LAB |

``lut``, ``blur``, ``median_blur``, ``gaussian_blur5``, ``equalize_hist``, ``rgb2gray``, ``bgr2hsv``,
``rgb2lab``, ``convex_hull`` and the INTER_LINEAR ``resize`` compute what OpenCV computes, byte for byte;
``min_area_rect`` finds OpenCV's rectangle up to the last bits of its size and angle (ties between
hull edges aside). The others compute
the same function in floating point where OpenCV uses fixed point or other roundings,
and may differ from it by a grey level on some bytes; ``tests/test_torch_data.py`` measures each
op's residue against the installed OpenCV (ROADMAP, "Known differences").
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from bsyolo_tpu_torch.ops.resize import resize_linear_u8

INTER_LINEAR, INTER_AREA = 1, 3


def _round_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


# --- resize ------------------------------------------------------------------------------------------


def _area_weights(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) weights of OpenCV's INTER_AREA when shrinking: the share of each source
    pixel under each destination pixel."""
    scale = n_in / n_out
    lo = np.arange(n_out) * scale
    hi = lo + scale
    src = np.arange(n_in)
    overlap = np.clip(np.minimum(hi[:, None], src[None] + 1) - np.maximum(lo[:, None], src[None]), 0, None)
    return (overlap / scale).astype(np.float64)


def resize(img: np.ndarray, dsize: Tuple[int, int], interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=...)``: INTER_LINEAR (``ops/resize.py resize_linear_u8``,
    OpenCV's 8-bit fixed-point arithmetic), or INTER_AREA when shrinking (INTER_AREA when enlarging
    falls back to INTER_LINEAR here)."""
    w, h = int(dsize[0]), int(dsize[1])
    h0, w0 = img.shape[:2]
    if (h, w) == (h0, w0):
        return img.copy()
    if interpolation != INTER_AREA or h > h0 or w > w0:
        x = torch.from_numpy(np.ascontiguousarray(img))
        x = x.permute(2, 0, 1) if img.ndim == 3 else x
        out = resize_linear_u8(x, (h, w))
        return np.ascontiguousarray((out.permute(1, 2, 0) if img.ndim == 3 else out).numpy())
    wy, wx = _area_weights(h, h0), _area_weights(w, w0)
    c = img.shape[2] if img.ndim == 3 else 1
    x = (wy @ img.reshape(h0, w0 * c).astype(wy.dtype)).reshape(h, w0, c)  # rows, then columns
    out = (x.transpose(0, 2, 1) @ wx.T).transpose(0, 2, 1)
    if h0 % h == 0 and w0 % w == 0:  # OpenCV's integer-factor path rounds halves up
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8).reshape((h, w) + img.shape[2:])
    return _round_u8(out).reshape((h, w) + img.shape[2:])


# --- geometric warps ---------------------------------------------------------------------------------


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the (2, 3) float64 matrix rotating by ``angle`` degrees
    (counter-clockwise) and scaling about ``center``."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _sample_bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border) -> np.ndarray:
    """Bilinear samples of ``img`` at (sx, sy), neighbours outside the image taking ``border``."""
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    src = img.reshape(h, w, c).astype(np.float32)
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    tx = (sx - x0).astype(np.float32)[..., None]
    ty = (sy - y0).astype(np.float32)[..., None]
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    fill = np.asarray(border, np.float32).reshape(-1)[:c] if np.ndim(border) else np.full(c, border, np.float32)
    out = np.zeros(sx.shape + (c,), np.float32)
    for dy, wy in ((0, 1 - ty), (1, ty)):
        for dx, wx in ((0, 1 - tx), (1, tx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            v = np.where(inside[..., None], src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)], fill)
            out += wy * wx * v
    return _round_u8(out).reshape(sx.shape + img.shape[2:])


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int], border_value=(114, 114, 114)) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, borderValue=...)``, INTER_LINEAR: each destination pixel
    samples the source at the inverse map of its position (the inverse in float64)."""
    m = np.asarray(m, np.float64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    w, h = int(dsize[0]), int(dsize[1])
    xs = np.arange(w, dtype=np.float64)[None]
    ys = np.arange(h, dtype=np.float64)[:, None]
    sx = (a11 * xs + a12 * ys + b1).astype(np.float32)
    sy = (a21 * xs + a22 * ys + b2).astype(np.float32)
    return _sample_bilinear(img, sx, sy, border_value)


def warp_perspective(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                     border_value=(114, 114, 114)) -> np.ndarray:
    """``cv2.warpPerspective(img, m, dsize, borderValue=...)``, INTER_LINEAR."""
    inv = np.linalg.inv(np.asarray(m, np.float64).reshape(3, 3))
    w, h = int(dsize[0]), int(dsize[1])
    xs = np.arange(w, dtype=np.float64)[None]
    ys = np.arange(h, dtype=np.float64)[:, None]
    z = inv[2, 0] * xs + inv[2, 1] * ys + inv[2, 2]
    z = np.where(z != 0, 1.0 / np.where(z != 0, z, 1.0), 0.0)
    sx = ((inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]) * z).astype(np.float32)
    sy = ((inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]) * z).astype(np.float32)
    return _sample_bilinear(img, sx, sy, border_value)


# --- colour ------------------------------------------------------------------------------------------

_HSV_SHIFT = 12
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256)))]).astype(np.int32)


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on uint8: H in [0, 180), OpenCV's integer tables."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))  # products stay below 2**28
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv2bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` on uint8 (H in [0, 180)), in float32 as OpenCV;
    the result truncated to an integer, as OpenCV 5's vector path truncates (its scalar path,
    for images a few pixels wide, rounds)."""
    h = img[..., 0].astype(np.float32) * np.float32(6.0 / 180)
    s = img[..., 1].astype(np.float32) * np.float32(1 / 255)
    v = img[..., 2].astype(np.float32) * np.float32(1 / 255)
    h = np.where(h >= 6, h - 6, h)
    sector = np.floor(h).astype(np.int64)
    f = h - sector
    sector = np.clip(sector, 0, 5)
    tab = np.stack([v, v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))], -1)
    idx = _SECTORS[sector]
    bgr = np.take_along_axis(tab, idx, -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.clip(np.floor(bgr * np.float32(255)), 0, 255).astype(np.uint8)


def lut(img: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``cv2.LUT``: each byte through a 256-entry table."""
    return np.asarray(table)[img]


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` on uint8: OpenCV's 15-bit weights, rounded."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)


# --- filters -----------------------------------------------------------------------------------------


def blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(img, (k, k))``: the k x k mean, border BORDER_REFLECT_101, rounded."""
    p = k // 2
    pad = [(p, p), (p, p)] + [(0, 0)] * (img.ndim - 2)
    x = np.pad(img.astype(np.int64), pad, mode="reflect")
    c = np.cumsum(np.cumsum(x, 0), 1)
    c = np.pad(c, [(1, 0), (1, 0)] + [(0, 0)] * (img.ndim - 2))
    h, w = img.shape[:2]
    s = c[k : k + h, k : k + w] - c[:h, k : k + w] - c[k : k + h, :w] + c[:h, :w]
    return _round_u8(s * (1.0 / (k * k)))


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(img, k)``: the k x k median, border BORDER_REPLICATE."""
    p = k // 2
    pad = [(p, p), (p, p)] + [(0, 0)] * (img.ndim - 2)
    x = np.pad(img, pad, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(x, (k, k), axis=(0, 1))
    win = win.reshape(win.shape[: img.ndim] + (k * k,))
    return np.partition(win, k * k // 2, axis=-1)[..., k * k // 2]


def gaussian_blur5(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (5, 5), 0)`` on uint8: OpenCV's 5-tap kernel (1, 4, 6, 4, 1) / 16 in each
    direction, border BORDER_REFLECT_101, the 1/256 sum rounded half up as OpenCV's fixed-point path does."""
    pad = [(2, 2), (2, 2)] + [(0, 0)] * (img.ndim - 2)
    x = np.pad(img.astype(np.int64), pad, mode="reflect")
    h, w = img.shape[:2]
    k = (1, 4, 6, 4, 1)
    rows = sum(k[j] * x[:, j : j + w] for j in range(5))
    s = sum(k[i] * rows[i : i + h] for i in range(5))
    return ((s + 128) >> 8).astype(np.uint8)


def equalize_hist(gray: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of a uint8 image: the cumulative histogram past the first occupied level,
    scaled by 255 / (pixels - that level's count) in float32 and rounded to nearest even; a constant
    image keeps its level."""
    hist = np.bincount(gray.reshape(-1), minlength=256)
    first = int(np.flatnonzero(hist)[0])
    total = gray.size
    if hist[first] == total:
        return np.full_like(gray, first)
    scale = np.float32(255.0) / np.float32(total - hist[first])
    table = np.zeros(256, np.uint8)
    cum = np.cumsum(hist[first + 1 :]).astype(np.float32)
    table[first + 1 :] = np.clip(np.rint(cum * scale), 0, 255).astype(np.uint8)
    return table[gray]


# --- CLAHE on the L channel of Lab -------------------------------------------------------------------

_D65 = np.array([0.950456, 1.0, 1.088754])
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])


def _lab_tables():
    """OpenCV's 8-bit RGB2Lab tables: the sRGB gamma at 3 extra bits, the cube root at 15, the
    XYZ rows over the white point at 12 (float32 where OpenCV computes in float)."""
    f32 = np.float32
    x = np.arange(256, dtype=f32) * f32(1 / 255)
    lin = np.where(x <= f32(0.04045), x * f32(1 / 12.92), np.power((x + f32(0.055)) / f32(1.055), f32(2.4)))
    gamma = np.clip(np.rint(f32(255 * 8) * lin.astype(f32)), 0, 65535).astype(np.int64)
    t = np.arange(256 * 3 // 2 * 8, dtype=f32) * f32(1 / (255 * 8))
    cbrt = np.where(t < f32(0.008856), t * f32(7.787) + f32(16 / 116), np.cbrt(t).astype(f32))
    cbrt = np.clip(np.rint(f32(1 << 15) * cbrt.astype(f32)), 0, 65535).astype(np.int64)
    coeffs = np.rint((1 << 12) * _RGB2XYZ / _D65[:, None]).astype(np.int64)
    return gamma, cbrt, coeffs


_LAB_GAMMA, _LAB_CBRT, _LAB_XYZ = _lab_tables()


def _descale(v, n):
    return (v + (1 << (n - 1))) >> n


def rgb2lab(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2LAB)`` on uint8 (L * 255 / 100, a + 128, b + 128): OpenCV's
    fixed-point tables, byte for byte."""
    rgb = _LAB_GAMMA[img[..., :3]]
    fx, fy, fz = (_LAB_CBRT[_descale(rgb @ _LAB_XYZ[i], 12)] for i in range(3))
    L = _descale((116 * 255 + 50) // 100 * fy - (16 * 255 * (1 << 15) + 50) // 100, 15)
    a = _descale(500 * (fx - fy) + (128 << 15), 15)
    b = _descale(200 * (fy - fz) + (128 << 15), 15)
    return np.clip(np.stack([L, a, b], -1), 0, 255).astype(np.uint8)


def _linear_to_srgb(c):
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.power(np.clip(c, 0, None), 1 / 2.4) - 0.055)


def lab2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_LAB2RGB)`` on uint8, in float64 (OpenCV's fixed-point
    inverse is not copied: within 1 grey level on 99.99 % of bytes, max 2)."""
    L = img[..., 0].astype(np.float64) * 100 / 255
    a = img[..., 1].astype(np.float64) - 128
    b = img[..., 2].astype(np.float64) - 128
    fy = (L + 16) / 116
    y = np.where(L > 903.3 * 0.008856, fy ** 3, L / 903.3)
    fy = np.where(L > 903.3 * 0.008856, fy, 7.787 * y + 16 / 116)
    fx, fz = fy + a / 500, fy - b / 200

    def finv(t):
        return np.where(t > 0.206893, t ** 3, (t - 16 / 116) / 7.787)

    xyz = np.stack([finv(fx), y, finv(fz)], -1) * _D65
    rgb = xyz @ np.linalg.inv(_RGB2XYZ).T
    return _round_u8(_linear_to_srgb(np.clip(rgb, 0, 1)) * 255)


def clahe_gray(gray: np.ndarray, clip_limit: float = 4.0, tiles: int = 8) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, (tiles, tiles)).apply(gray)`` on a uint8 (h, w) image:
    per-tile clipped histograms equalised, then each pixel bilinear between its four
    nearest tiles' maps."""
    h, w = gray.shape
    ph, pw = (-h) % tiles, (-w) % tiles
    src = np.pad(gray, ((0, ph), (0, pw)), mode="reflect") if ph or pw else gray
    th, tw = src.shape[0] // tiles, src.shape[1] // tiles
    area = th * tw
    blocks = src.reshape(tiles, th, tiles, tw).transpose(0, 2, 1, 3).reshape(tiles, tiles, area)
    hist = np.zeros((tiles, tiles, 256), np.int64)
    np.add.at(hist, (np.arange(tiles)[:, None, None], np.arange(tiles)[None, :, None], blocks), 1)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / 256), 1)
        clipped = np.maximum(hist - limit, 0).sum(-1)
        hist = np.minimum(hist, limit)
        batch, residual = clipped // 256, clipped % 256
        hist += batch[..., None]
        step = np.maximum(256 // np.maximum(residual, 1), 1)
        idx = np.arange(256)
        extra = (residual[..., None] > 0) & (idx % step[..., None] == 0) & (idx // step[..., None] < residual[..., None])
        hist += extra
    luts = _round_u8(np.cumsum(hist, -1).astype(np.float32) * np.float32(255 / area))
    yf = np.arange(h, dtype=np.float32) * np.float32(1 / th) - np.float32(0.5)
    xf = np.arange(w, dtype=np.float32) * np.float32(1 / tw) - np.float32(0.5)
    y1 = np.floor(yf).astype(np.int64)
    x1 = np.floor(xf).astype(np.int64)
    ya, xa = (yf - y1)[:, None], (xf - x1)[None]
    y2, x2 = np.clip(y1 + 1, 0, tiles - 1), np.clip(x1 + 1, 0, tiles - 1)
    y1, x1 = np.clip(y1, 0, tiles - 1), np.clip(x1, 0, tiles - 1)
    g = gray
    v = lambda ty, tx: luts[ty[:, None], tx[None], g].astype(np.float32)  # noqa: E731
    out = (v(y1, x1) * (1 - xa) + v(y1, x2) * xa) * (1 - ya) + (v(y2, x1) * (1 - xa) + v(y2, x2) * xa) * ya
    return _round_u8(out)


def clahe(img: np.ndarray, clip_limit: float = 4.0, tile: int = 8) -> np.ndarray:
    """CLAHE of an RGB image's Lab lightness (``bsyolo_tpu/data/photometric.py clahe``)."""
    lab = rgb2lab(img)
    lab[..., 0] = clahe_gray(lab[..., 0], clip_limit, tile)
    return lab2rgb(lab)


def gray2rgb(gray: np.ndarray) -> np.ndarray:
    return np.repeat(gray[..., None], 3, -1)



_fill_lib = None


def fill_poly(img: np.ndarray, polys, color: int = 1) -> np.ndarray:
    """``cv2.fillPoly(img, polys, color)`` on a 2-D uint8 image, in place, byte for byte: each polygon
    an (n, 2) array of integer (x, y) points (int32 range), the default 8-connected line type, no
    fractional bits. Host C++ (``kernels/csrc/fillpoly.cpp``, OpenCV's edge list and scan
    conversion), built at first use by the host compiler. Returns ``img``."""
    global _fill_lib
    import ctypes

    if img.dtype != np.uint8 or img.ndim != 2 or not img.flags.c_contiguous:
        raise ValueError(f"fill_poly takes a contiguous 2-D uint8 image, got {img.dtype} {img.shape}")
    polys = [np.asarray(p).reshape(-1, 2) for p in polys]
    if any(not np.issubdtype(p.dtype, np.integer) for p in polys):
        raise TypeError("fill_poly takes integer points, as cv2.fillPoly takes int32 ones")
    if _fill_lib is None:
        from bsyolo_tpu_torch.kernels.build import load_library

        lib = load_library("fillpoly")
        lib.bsy_fill_poly.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int]
        lib.bsy_fill_poly.restype = ctypes.c_int
        _fill_lib = lib
    pts = np.ascontiguousarray(np.concatenate(polys) if polys else np.zeros((0, 2)), np.int32)
    npts = np.asarray([len(p) for p in polys], np.int32)
    _fill_lib.bsy_fill_poly(img.ctypes.data, img.shape[0], img.shape[1], pts.ctypes.data, npts.ctypes.data,
                            len(polys), int(color))
    return img


# --- minimum-area rectangle ---------------------------------------------------------------------------


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _sklansky(p, start: int, end: int, nsign: int, sign2: int):
    """OpenCV's ``Sklansky_``: the indices (into the x-sorted points ``p``) of one quarter of the hull
    from ``start`` towards ``end``, the last one dropped."""
    incr = 1 if end > start else -1
    if start == end or (p[start][0] == p[end][0] and p[start][1] == p[end][1]):
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext] + [0] * (abs(end - start) + 3)
    size = 3
    end += incr
    while pnext != end:
        by = p[pnext][1] - p[pcur][1]
        if _sign(by) != nsign:
            ax, bx = p[pcur][0] - p[pprev][0], p[pnext][0] - p[pcur][0]
            ay = p[pcur][1] - p[pprev][1]
            if _sign(float(ay) * float(bx) - float(ax) * float(by)) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[size - 2] = pnext
                pcur = pprev
                pprev = stack[size - 4]
                size -= 1
        else:
            pnext += incr
            stack[size - 1] = pnext
    return stack[: size - 1]


def convex_hull(points: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(points)`` of float32 (n, 2) points (clockwise=False, the points returned): Sklansky's
    scan over the points sorted by x then y, upper and lower halves, then the cyclic shift OpenCV applies so
    that the point indices ascend or descend."""
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    total = len(pts)
    if total == 0:
        return pts
    order = sorted(range(total), key=lambda i: (pts[i][0], pts[i][1]))
    p = [pts[i] for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if p[miny][1] > p[i][1]:
            miny = i
        if p[maxy][1] < p[i][1]:
            maxy = i
    if p[0][0] == p[-1][0] and p[0][1] == p[-1][1]:
        return pts[[order[0]]]
    tr = _sklansky(p, 0, maxy, -1, 1)  # counter-clockwise: the two upper quarters swap
    tl = _sklansky(p, total - 1, maxy, -1, -1)
    hull = [order[tl[i]] for i in range(len(tl) - 1)] + [order[tr[i]] for i in range(len(tr) - 1, 0, -1)]
    stop = tr[1] if len(tr) > 2 else (tl[-2] if len(tl) > 2 else -1)
    bl = _sklansky(p, 0, miny, 1, -1)
    br = _sklansky(p, total - 1, miny, 1, 1)
    nbl, nbr = len(bl), len(br)
    if stop >= 0:
        check = bl[1] if nbl > 2 else (br[2 - nbl] if nbl + nbr > 2 else -1)
        if check == stop or (check >= 0 and p[check][0] == p[stop][0] and p[check][1] == p[stop][1]):
            nbl, nbr = min(nbl, 2), min(nbr, 2)  # collinear: the lower half mirrors the upper one
    hull += [order[bl[i]] for i in range(nbl - 1)] + [order[br[i]] for i in range(nbr - 1, 0, -1)]
    n = len(hull)
    if n >= 3:  # cyclic shift towards an ascending or descending index sequence
        mn = mx = lt = 0
        for i in range(1, n):
            lt += hull[i - 1] < hull[i]
            if 1 < lt <= i - 2:
                break
            mn = i if hull[i] < hull[mn] else mn
            mx = i if hull[i] > hull[mx] else mx
        mm = abs(mx - mn)
        if (mm == 1 or mm == n - 1) and (lt <= 1 or lt >= n - 2):
            asc = (mx + 1) % n == mn
            j = mn if asc else mx
            if j > 0:
                shifted = []
                for i in range(n):
                    shifted.append(hull[j])
                    nj = (j + 1) % n
                    if i < n - 1 and asc != (hull[j] < hull[nj]):
                        break
                    j = nj
                else:
                    hull = shifted
    return pts[hull]


def _rotating_calipers(p):
    """OpenCV's rotating calipers over a convex polygon (float32 (n, 2), n > 2), in float32: the corner
    and the two side vectors of the minimum-area rectangle, the last of the equal minima, and the unit
    direction of the first side."""
    f = np.float32
    n = len(p)
    vect, inv = [], []
    left = bottom = right = top = 0
    for i in range(n):
        x, y = p[i]
        if x < p[left][0]:
            left = i
        if x > p[right][0]:
            right = i
        if y > p[top][1]:
            top = i
        if y < p[bottom][1]:
            bottom = i
        dx, dy = p[(i + 1) % n][0] - x, p[(i + 1) % n][1] - y
        vect.append((dx, dy))
        inv.append(f(1.0 / math.sqrt(float(dx) ** 2 + float(dy) ** 2)))
    orientation = f(0)
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    for bx, by in vect:
        c = ax * float(by) - ay * float(bx)
        if c != 0:
            orientation = f(1) if c > 0 else f(-1)
            break
        ax, ay = float(bx), float(by)
    base_a, base_b = orientation, f(0)
    seq = [bottom, right, top, left]
    minarea, best = f(np.finfo(np.float32).max), None
    for _ in range(n):
        v = [vect[s] for s in seq]
        dp = (base_a * v[0][0] + base_b * v[0][1], -base_b * v[1][0] + base_a * v[1][1],
              -base_a * v[2][0] - base_b * v[2][1], base_b * v[3][0] - base_a * v[3][1])
        main, maxcos = 0, dp[0] * inv[seq[0]]
        for i in range(1, 4):
            c = dp[i] * inv[seq[i]]
            if c > maxcos:
                main, maxcos = i, c
        k = seq[main]
        lx, ly = vect[k][0] * inv[k], vect[k][1] * inv[k]
        base_a, base_b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = (seq[main] + 1) % n
        width = (p[seq[1]][0] - p[seq[3]][0]) * base_a + (p[seq[1]][1] - p[seq[3]][1]) * base_b
        height = -(p[seq[2]][0] - p[seq[0]][0]) * base_b + (p[seq[2]][1] - p[seq[0]][1]) * base_a
        area = width * height
        if area <= minarea:
            minarea, best = area, (seq[3], base_a, width, base_b, height, seq[0])
    lft, a1, width, b1, height, bot = best
    a2, b2 = -b1, a1
    c1 = a1 * p[lft][0] + p[lft][1] * b1
    c2 = a2 * p[bot][0] + p[bot][1] * b2
    idet = f(1) / (a1 * b2 - a2 * b1)
    corner = ((c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet)
    return corner, (a1 * width, b1 * width), (a2 * height, b2 * height), (a1, b1)


def min_area_rect(points: np.ndarray):
    """``cv2.minAreaRect(points)``: ((cx, cy), (w, h), angle in degrees) of the smallest rectangle around
    float32 (n, 2) points, in OpenCV 5's convention: the angle in [-90, 0), width and height swapped each
    time it is turned by 90 degrees into that range. The convex hull (``convex_hull``) and the rotating
    calipers are OpenCV's in float32; the size and angle may differ from OpenCV's in their last bits, and
    where two rectangles tie for the least area (a square, a right triangle) the other one may be chosen.
    A rectangle of zero width (collinear points) takes the angle of the calipers' base."""
    f = np.float32
    hull = convex_hull(points)
    n = len(hull)
    if n > 2:
        c, u, v, base = _rotating_calipers(hull)
        center = (c[0] + (u[0] + v[0]) * f(0.5), c[1] + (u[1] + v[1]) * f(0.5))
        w = math.sqrt(float(u[0]) ** 2 + float(u[1]) ** 2)
        h = math.sqrt(float(v[0]) ** 2 + float(v[1]) ** 2)
        angle = math.atan2(float(u[1]), float(u[0])) if w else math.atan2(float(base[1]), float(base[0]))
    elif n == 2:
        center = ((hull[0][0] + hull[1][0]) * f(0.5), (hull[0][1] + hull[1][1]) * f(0.5))
        dx, dy = float(hull[1][0]) - float(hull[0][0]), float(hull[1][1]) - float(hull[0][1])
        w, h, angle = math.sqrt(dx * dx + dy * dy), 0.0, math.atan2(dy, dx)
    else:
        center = (hull[0][0], hull[0][1]) if n else (f(0), f(0))
        w = h = angle = 0.0
    w, h, angle = f(w), f(h), f(f(angle) * 180 / math.pi)
    while angle >= 0:
        angle, w, h = f(angle - 90), h, w
    while angle < -90:
        angle, w, h = f(angle + 90), h, w
    return (float(center[0]), float(center[1])), (float(w), float(h)), float(angle)
