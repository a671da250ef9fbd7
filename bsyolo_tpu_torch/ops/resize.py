"""OpenCV's 8-bit bilinear resize on any torch device.

``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` on uint8 images is
fixed-point arithmetic: 11-bit weights per axis (each rounded on its own),
a horizontal pass into int32 rows, and a vertical pass that shifts each row
right by 4 before a 16-bit high multiply, then rounds with ``(t + 2) >> 2``.
Horizontal source positions are clamped at the borders with the weight moved
onto the edge pixel; vertical weights are not, only the rows are. This is the
arithmetic of OpenCV 5.0's vectorized path, and ``tests/test_torch_app.py``
holds it equal, byte for byte, to ``cv2.resize`` at shrinking, enlarging and
odd sizes. The segmenter (``app/grfb_unet.py``) resizes with it on the card,
where OpenCV is not installed, and ``data/cv.py resize`` with it on the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

_ONE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE: 11 fractional bits


@lru_cache(maxsize=64)
def _axis(n_out: int, n_in: int, clamp_weights: bool) -> Tuple[np.ndarray, ...]:
    """Source indices (i0, i1) and fixed-point weights (w0, w1) of one axis."""
    scale = 1.0 / (n_out / n_in)  # as OpenCV computes it: the inverse of the inverse scale
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp_weights:
        f[i0 < 0] = 0
        i0[i0 < 0] = 0
        f[i0 >= n_in - 1] = 0
        i0[i0 >= n_in - 1] = n_in - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(_ONE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_ONE)).astype(np.int32)
    return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w0, w1


def resize_linear_u8(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) uint8 tensor -> (..., h, w) uint8, ``size`` = (h, w): OpenCV's INTER_LINEAR on
    8-bit images (module docstring), on ``x``'s device."""
    if x.dtype != torch.uint8:
        raise ValueError(f"expected a uint8 tensor, got {x.dtype}")
    h, w = size
    dev = x.device
    xi0, xi1, xw0, xw1 = (torch.from_numpy(a).to(dev) for a in _axis(w, x.shape[-1], True))
    yi0, yi1, yw0, yw1 = (torch.from_numpy(a).to(dev) for a in _axis(h, x.shape[-2], False))
    s = x.to(torch.int32)
    rows = s.index_select(-1, xi0) * xw0 + s.index_select(-1, xi1) * xw1  # (..., H, w): value * 2048
    r0 = rows.index_select(-2, yi0) >> 4
    r1 = rows.index_select(-2, yi1) >> 4
    out = ((yw0[:, None] * r0) >> 16) + ((yw1[:, None] * r1) >> 16)
    return ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)
