"""Outer borders of binary masks without OpenCV: ``cv2.findContours(m, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``.

The Suzuki-Abe border follower as OpenCV 5.0 runs it for ``RETR_EXTERNAL`` is host
C++ (``kernels/csrc/contours.cpp``, built at first use by the host compiler and
bound with ctypes): the mask (any nonzero pixel is foreground, 8-connected) is
framed by one row and column of background, so pixels on the image's edge are
followed like any other; a raster scan starts an outer border at each 0 -> 1
step whose last marked border pixel on the row is not a component's left side,
so holes and their islands are never followed. Each border is followed
counter-clockwise from its first pixel, and ``CHAIN_APPROX_SIMPLE`` keeps a
point where the direction of the chain changes. The contours come out in
OpenCV's order: the last border found first. ``contour_area`` and
``largest_contour`` are ``cv2.contourArea`` and the JAX package's choice among
them.
"""

from __future__ import annotations

from typing import List

import numpy as np

_lib = None


def _library():
    global _lib
    if _lib is None:
        import ctypes

        from bsyolo_tpu_torch.kernels.build import load_library

        lib = load_library("contours")
        lib.bsy_contours_find.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p]
        lib.bsy_contours_find.restype = ctypes.c_void_p
        lib.bsy_contours_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.bsy_contours_take.restype = None
        _lib = lib
    return _lib


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """The outer border of each outermost 8-connected component of the 2-D ``mask`` (nonzero is
    foreground), as ``cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]`` gives them:
    a list of (n, 1, 2) int32 arrays of x, y points, in OpenCV's order."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"find_external_contours takes a 2-D mask, got shape {mask.shape}")
    fg = np.ascontiguousarray(mask.astype(bool, copy=False)).view(np.uint8)
    lib = _library()
    counts = np.zeros(2, np.int64)  # contours, points
    handle = lib.bsy_contours_find(fg.ctypes.data, fg.shape[0], fg.shape[1], counts.ctypes.data,
                                   counts[1:].ctypes.data)
    pts = np.empty((int(counts[1]), 1, 2), np.int32)
    sizes = np.empty(int(counts[0]), np.int32)
    lib.bsy_contours_take(handle, pts.ctypes.data, sizes.ctypes.data)
    return np.split(pts, np.cumsum(sizes)[:-1]) if len(sizes) else []


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea``: the unsigned shoelace area of the closed polygon."""
    pts = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(pts) < 3:
        return 0.0
    x, y = pts[:, 0], pts[:, 1]
    return abs(float(np.dot(np.roll(x, 1), y) - np.dot(np.roll(y, 1), x))) * 0.5


def largest_contour(mask: np.ndarray) -> np.ndarray:
    """(n, 2) float32 points of the largest outer border of ``mask`` by area, the first in OpenCV's
    order among equals (``max(cs, key=cv2.contourArea)``), or (0, 2) when the mask is empty."""
    cs = find_external_contours(mask)
    if not cs:
        return np.zeros((0, 2), np.float32)
    return max(cs, key=contour_area).reshape(-1, 2).astype(np.float32)
