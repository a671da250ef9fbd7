"""numpy counterparts of the OpenCV calls on the detect data path.

The port's data pipeline runs where OpenCV may not be installed, so each cv2
call that ``bsyolo_tpu/data`` makes on the detect path has a numpy version
here, on uint8 (h, w[, c]) images:

| function | replaces |
| --- | --- |
| ``resize`` | ``cv2.resize`` INTER_LINEAR and INTER_AREA |
| ``warp_affine``, ``warp_perspective`` | ``cv2.warpAffine`` / ``cv2.warpPerspective``, INTER_LINEAR, constant border |
| ``rotation_matrix_2d`` | ``cv2.getRotationMatrix2D`` |
| ``bgr2hsv``, ``hsv2bgr``, ``lut`` | ``cv2.cvtColor`` BGR2HSV / HSV2BGR (8-bit, H in [0, 180)), ``cv2.LUT`` |
| ``blur``, ``median_blur`` | ``cv2.blur`` (BORDER_REFLECT_101), ``cv2.medianBlur`` (BORDER_REPLICATE) |
| ``rgb2gray`` | ``cv2.cvtColor`` RGB2GRAY (OpenCV's 15-bit fixed-point weights) |
| ``clahe`` | ``cv2.createCLAHE(...).apply`` on the L channel of ``cv2.cvtColor`` RGB2LAB |

``lut``, ``blur``, ``median_blur``, ``rgb2gray``, ``bgr2hsv`` and ``rgb2lab``
compute what OpenCV computes, byte for byte. The others compute the same function in floating
point where OpenCV uses fixed point or other roundings, and may differ from
it by a grey level on some bytes; ``tests/test_torch_data.py`` measures each
op's residue against the installed OpenCV (ROADMAP, "Known differences").
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

INTER_LINEAR, INTER_AREA = 1, 3


def _round_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


# --- resize ------------------------------------------------------------------------------------------


def _linear_weights(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear weights, pixel centres aligned (OpenCV's INTER_LINEAR), edges clamped."""
    scale = n_in / n_out
    f = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.floor(f).astype(np.int64)
    t = (f - i0).astype(np.float32)
    t = np.where(i0 < 0, 0.0, t)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    t = np.where(i0 >= n_in - 1, 0.0, t)
    wts = np.zeros((n_out, n_in), np.float32)
    np.add.at(wts, (np.arange(n_out), i0), 1 - t)
    np.add.at(wts, (np.arange(n_out), i1), t)
    return wts


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
    """``cv2.resize(img, (w, h), interpolation=...)``: INTER_LINEAR, or INTER_AREA when
    shrinking (INTER_AREA when enlarging falls back to INTER_LINEAR here)."""
    w, h = int(dsize[0]), int(dsize[1])
    h0, w0 = img.shape[:2]
    if (h, w) == (h0, w0):
        return img.copy()
    area = interpolation == INTER_AREA and h <= h0 and w <= w0
    if interpolation == INTER_LINEAR and h0 == 2 * h and w0 == 2 * w:
        area = True  # OpenCV takes the area path for an exact halving
    wy = _area_weights(h, h0) if area else _linear_weights(h, h0)
    wx = _area_weights(w, w0) if area else _linear_weights(w, w0)
    c = img.shape[2] if img.ndim == 3 else 1
    x = (wy @ img.reshape(h0, w0 * c).astype(wy.dtype)).reshape(h, w0, c)  # rows, then columns
    out = (x.transpose(0, 2, 1) @ wx.T).transpose(0, 2, 1)
    if area and h0 % h == 0 and w0 % w == 0:  # OpenCV's integer-factor path rounds halves up
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
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256)))]).astype(np.int64)


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on uint8: H in [0, 180), OpenCV's integer tables."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
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

