"""ctypes binding of the repository's native runtime support library, ``native/bsyolo_native.cpp``
(counterpart of ``bsyolo_tpu/utils/native.py``): letterbox, greedy NMS and box rescaling with numpy
interfaces, the host pre- and post-processing a C++ serving client shares with Python.

The library builds at first use through ``kernels/build.py``'s host route (the host C++ compiler,
``-O3 -fPIC -shared -std=c++17``) into ``build/bsyolo_tpu_torch/``, named by a hash of source and flags,
never beside its source. The port's Python and CUDA paths remain the source of truth; nothing of the
predict path calls this library.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from bsyolo_tpu_torch.kernels.build import load_library

_U8P, _F32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed), its functions typed."""
    lib = load_library("bsyolo_native")
    lib.bsy_letterbox.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_uint8]
    lib.bsy_letterbox.restype = ctypes.c_float
    lib.bsy_nms.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, _F32P]
    lib.bsy_nms.restype = ctypes.c_int
    lib.bsy_scale_boxes.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.bsy_scale_boxes.restype = None
    return lib


def letterbox(img: np.ndarray, new_shape: Tuple[int, int] = (640, 640), pad_value: int = 114):
    """uint8 HWC ``img`` letterboxed to ``new_shape`` by the native library -> (out, ratio)."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3:
        raise ValueError(f"letterbox takes an (H, W, C) uint8 image, got shape {img.shape}")
    h, w, ch = img.shape
    out = np.empty((new_shape[0], new_shape[1], ch), np.uint8)
    r = lib.bsy_letterbox(img.ctypes.data_as(_U8P), h, w, ch, out.ctypes.data_as(_U8P), new_shape[0], new_shape[1],
                          pad_value)
    return out, float(r)


def nms(preds: np.ndarray, conf_thres: float = 0.25, iou_thres: float = 0.7, max_det: int = 300) -> np.ndarray:
    """Decoded predictions (n, 4 + nc), xywh pixels and class scores -> (m, 6) x1, y1, x2, y2, conf, cls
    rows by the native greedy NMS."""
    lib = load()
    preds = np.ascontiguousarray(preds, dtype=np.float32)
    if preds.ndim != 2 or preds.shape[1] < 5:
        raise ValueError(f"nms takes (n, 4 + nc) predictions, got shape {preds.shape}")
    n, width = preds.shape
    out = np.zeros((max_det, 6), np.float32)
    m = lib.bsy_nms(preds.ctypes.data_as(_F32P), n, width - 4, conf_thres, iou_thres, max_det, out.ctypes.data_as(_F32P))
    return out[:m]


def scale_boxes(boxes: np.ndarray, lb_shape: Tuple[int, int], orig_shape: Tuple[int, int]) -> np.ndarray:
    """(n, 6) letterboxed rows rescaled to ``orig_shape`` pixels by the native library (a copy when
    ``boxes`` is not contiguous float32, else in place); returns the rescaled rows."""
    lib = load()
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    if boxes.ndim != 2 or boxes.shape[1] < 4:
        raise ValueError(f"scale_boxes takes (n, >= 4) rows, got shape {boxes.shape}")
    lib.bsy_scale_boxes(boxes.ctypes.data_as(_F32P), len(boxes), lb_shape[0], lb_shape[1], orig_shape[0], orig_shape[1])
    return boxes
