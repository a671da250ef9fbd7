"""Image files without OpenCV (counterpart of ``cv2.imread`` and of the PIL header read in
``bsyolo_tpu/data/dataset.py``).

- PNG is decoded here, through the standard library's ``zlib``: grey, grey +
  alpha, RGB, RGBA and palette images of 8 bits, not interlaced; other bit
  depths raise ``ImageFormatError``. The five row filters are undone in
  numpy; rows filtered with Average or Paeth depend on the pixel to their
  left, so an image that has such rows is unfiltered along anti-diagonals
  (every pixel of one diagonal at once, each depending only on earlier ones).
- BMP: uncompressed 8-, 24- and 32-bit files, bottom-up or top-down.
- ``.npy``: a saved (h, w, 3) or (h, w) uint8 array, taken as BGR.
- JPEG and the other suffixes go through ``cv2`` where it is importable; else
  ``imread`` raises ``ImportError`` (ROADMAP queue 1, item 21).

``imread`` returns (h, w, 3) uint8 BGR like ``cv2.imread`` (alpha dropped,
grey repeated) or None where the file is missing. ``image_size`` reads
(h, w) from PNG, BMP and JPEG headers without decoding pixels. ``imwrite_png``
writes a uint8 BGR or grey array as a PNG (filter None on every row).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


class ImageFormatError(ValueError):
    """The file is not an image this reader decodes."""


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise ImageFormatError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        yield kind, data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered rows -> (h, stride) bytes. Filters None, Sub and Up are
    undone row by row; an image with Average or Paeth rows is undone along
    anti-diagonals of (row, pixel), for all rows and filters at once."""
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ImageFormatError(f"PNG row filter {int(kinds.max())} does not exist")
    rows = raw[:, 1:]
    out = np.zeros((h, stride), np.uint8)
    if not np.isin(kinds, (3, 4)).any():
        prev = np.zeros(stride, np.uint8)
        for r in range(h):
            k, row = kinds[r], rows[r]
            if k == 1:  # Sub: a running sum per byte of the pixel, modulo 256
                row = np.cumsum(row.reshape(-1, bpp), 0, dtype=np.uint8).reshape(-1)
            elif k == 2:
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    # wavefront: pixel column c of row r (bpp bytes) depends on (r, c-1), (r-1, c), (r-1, c-1)
    w = stride // bpp
    x = np.zeros((h + 1, w + 1, bpp), np.int16)  # row 0 and column 0: the zeros before the image
    f = rows.astype(np.int16).reshape(h, w, bpp)
    k = kinds.astype(np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a, b, cc = x[r + 1, c], x[r, c + 1], x[r, c]  # left, up, up-left
        kr = k[r][:, None]
        pred = np.select([kr == 1, kr == 2, kr == 3, kr == 4], [a, b, (a + b) >> 1, _paeth(a, b, cc)], 0)
        x[r + 1, c + 1] = (f[r, c] + pred) & 255
    return x[1:, 1:].reshape(h, stride).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (h, w, 3) uint8 BGR."""
    ihdr, palette, idat = None, None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ImageFormatError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth != 8:
        raise ImageFormatError(f"PNG colour type {ctype} at bit depth {depth}: only 8-bit PNGs are read")
    if interlace:
        raise ImageFormatError("interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ImageFormatError("PNG image data is truncated")
    px = _unfilter(raw[: h * (stride + 1)].reshape(h, stride + 1), h, stride, ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ImageFormatError("palette PNG without PLTE")
        rgb = palette[np.minimum(px[..., 0], len(palette) - 1)]
    elif ch <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def decode_bmp(data: bytes) -> np.ndarray:
    """Uncompressed 8-, 24- or 32-bit BMP bytes -> (h, w, 3) uint8 BGR."""
    if data[:2] != b"BM":
        raise ImageFormatError("not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    w, h, _, depth, compression = struct.unpack("<iiHHI", data[18:34])
    if compression not in (0, 3) or depth not in (8, 24, 32):
        raise ImageFormatError(f"BMP of {depth} bits, compression {compression} is not supported")
    top_down, h = h < 0, abs(h)
    stride = (w * depth // 8 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=h * stride, offset=offset).reshape(h, stride)
    if depth == 8:
        n = struct.unpack("<I", data[46:50])[0] or 256
        table = np.frombuffer(data, np.uint8, count=4 * n, offset=14 + hsize).reshape(n, 4)[:, :3]
        img = table[rows[:, :w]]
    else:
        img = rows[:, : w * depth // 8].reshape(h, w, depth // 8)[..., :3]
    return np.ascontiguousarray(img if top_down else img[::-1])


def _imread_cv2(path: Path) -> Optional[np.ndarray]:
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs OpenCV (cv2), which is not installed: without it the port reads PNG, BMP and "
            ".npy images (JPEG without OpenCV is ROADMAP queue 1, item 21)") from e
    return cv2.imread(str(path))


def imread(path) -> Optional[np.ndarray]:
    """An image file -> (h, w, 3) uint8 BGR, or None where the file does not exist."""
    path = Path(path)
    if not path.is_file():
        return None
    suffix = path.suffix.lower()
    if suffix == ".npy":
        im = np.load(path)
        if im.dtype != np.uint8 or im.ndim not in (2, 3):
            raise ImageFormatError(f"{path}: expected a uint8 (h, w[, 3]) array, got {im.dtype} {im.shape}")
        return np.ascontiguousarray(np.repeat(im[..., None], 3, 2) if im.ndim == 2 else im)
    data = path.read_bytes()
    if data[:8] == _PNG_SIG:
        return decode_png(data)
    if data[:2] == b"BM":
        try:
            return decode_bmp(data)
        except ImageFormatError:
            return _imread_cv2(path)
    return _imread_cv2(path)


def image_size(path) -> Tuple[int, int]:
    """(h, w) of a PNG, BMP, JPEG or .npy file from its header alone."""
    path = Path(path)
    if path.suffix.lower() == ".npy":
        return tuple(np.load(path, mmap_mode="r").shape[:2])
    with open(path, "rb") as f:
        head = f.read(32)
        if head[:8] == _PNG_SIG:
            w, h = struct.unpack(">II", head[16:24])
            return h, w
        if head[:2] == b"BM":
            w, h = struct.unpack("<ii", head[18:26])
            return abs(h), w
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            while True:
                marker = f.read(2)
                if len(marker) < 2 or marker[0] != 0xFF:
                    break
                if marker[1] in (0xD8, 0x01) or 0xD0 <= marker[1] <= 0xD7:
                    continue
                n = struct.unpack(">H", f.read(2))[0]
                if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (0xC4, 0xC8, 0xCC):
                    h, w = struct.unpack(">xHH", f.read(5))
                    return h, w
                f.seek(n - 2, 1)
    raise ImageFormatError(f"{path}: no PNG, BMP or JPEG header")


def imwrite_png(path, img: np.ndarray, level: int = 1) -> None:
    """Write a uint8 (h, w, 3) BGR or (h, w) grey array as an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected a uint8 (h, w, 3) BGR or (h, w) array, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ctype = 2 if img.ndim == 3 else 0
    px = img[..., ::-1] if img.ndim == 3 else img
    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(px).reshape(h, -1)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    blob = (_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))
    Path(path).write_bytes(blob)
