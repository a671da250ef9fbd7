"""JPEG without OpenCV: ctypes binding of the port's own codec, ``kernels/csrc/jpeg.cpp``.

The codec is host C++ built from the repo's source at first use
(``kernels/build.py``, the host compiler); it needs no libjpeg. Its decoder
gives the pixels ``cv2.imread`` gives (libjpeg-turbo's ISLOW IDCT, fancy
upsampling and colour tables, the Exif orientation applied), and its encoder
the bytes ``cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])`` gives.
Both are byte-equal to OpenCV 5.0 (libjpeg-turbo 3.1) on the cases
``tests/test_torch_jpeg.py`` lists. ctypes releases the GIL for the call, so
decoding threads run in parallel.

Refused kinds (arithmetic coding, 12-bit samples, lossless and hierarchical
files, 4-component CMYK/YCCK) raise ``ImageFormatError`` (ROADMAP queue 1,
item 21 lists them).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from bsyolo_tpu_torch.kernels.build import load_library

_ERR_LEN = 256
_lib = None


class ImageFormatError(ValueError):
    """The file is not an image this reader decodes."""


def _load():
    global _lib
    if _lib is None:
        lib = load_library("jpeg")
        p_int = ctypes.POINTER(ctypes.c_int)
        lib.bsy_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, p_int, p_int, p_int, ctypes.c_char_p,
                                      ctypes.c_int]
        lib.bsy_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_char_p, ctypes.c_int]
        lib.bsy_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p, ctypes.c_int]
        lib.bsy_jpeg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        for f in (lib.bsy_jpeg_info, lib.bsy_jpeg_decode, lib.bsy_jpeg_encode):
            f.restype = ctypes.c_int
        lib.bsy_jpeg_free.restype = None
        _lib = lib
    return _lib


def _check(rc: int, err) -> None:
    if rc:
        msg = err.value.decode(errors="replace")
        if rc == 2:
            msg += " (ROADMAP queue 1, item 21)"
        raise ImageFormatError(msg)


def jpeg_info(data: bytes) -> Tuple[int, int, int]:
    """(h, w, channels) of JPEG bytes from the header: (h, w) after the Exif orientation,
    channels 1 (grey) or 3."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_load().bsy_jpeg_info(data, len(data), h, w, c, err, _ERR_LEN), err)
    return h.value, w.value, c.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (h, w, 3) uint8 BGR, as ``cv2.imread`` gives them."""
    h, w, _ = jpeg_info(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(_load().bsy_jpeg_decode(data, len(data), out.ctypes.data, h, w, err, _ERR_LEN), err)
    return out


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """A uint8 (h, w, 3) BGR or (h, w) grey array -> the JPEG bytes ``cv2.imencode`` gives at
    ``quality`` (baseline, 4:2:0 for colour, standard Huffman tables)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected a uint8 (h, w, 3) BGR or (h, w) array, got {img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    buf, n = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = _load()
    _check(lib.bsy_jpeg_encode(img.ctypes.data, img.shape[0], img.shape[1], 1 if img.ndim == 2 else 3, int(quality),
                               ctypes.byref(buf), ctypes.byref(n), err, _ERR_LEN), err)
    try:
        return ctypes.string_at(buf, n.value)
    finally:
        lib.bsy_jpeg_free(buf)
