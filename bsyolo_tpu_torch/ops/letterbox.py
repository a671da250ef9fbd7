"""Letterbox resize and pad (counterpart of ``bsyolo_tpu/ops/letterbox.py``).

``letterbox_params`` is the reference arithmetic, round-0.1 pad split
included. ``letterbox`` runs the resize on the chosen device with PyTorch's
bilinear interpolation (``align_corners=False``, no antialias) instead of
OpenCV's fixed-point INTER_LINEAR, so a resized frame may differ from the
OpenCV letterbox by a few grey levels; a frame that needs no resize is
copied exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def letterbox_params(
    shape: Tuple[int, int],
    new_shape: Tuple[int, int],
    scaleup: bool = True,
    center: bool = True,
    stride: int = 32,
    auto: bool = False,
    scale_fill: bool = False,
):
    """Compute (ratio, (dw, dh), unpadded (w, h)) like the reference LetterBox."""
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # (w, h)
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    if scale_fill:
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        r = 1.0
    if center:
        dw /= 2
        dh /= 2
    return r, (dw, dh), new_unpad


def letterbox(frame: np.ndarray, new_shape: Tuple[int, int], device, pad_value: int = 114) -> torch.Tensor:
    """(h, w, 3) BGR frame -> (3, H, W) RGB letterboxed tensor on ``device``.

    A uint8 frame gives a uint8 tensor (the resize rounds and clamps). A float32
    frame, on the same 0-255 scale, gives a float32 tensor, resized without
    rounding: the JAX predictor letterboxes such frames as they are and divides
    them by 255 afterwards, as the port's forward does with either dtype.
    """
    if frame.dtype not in (np.uint8, np.float32) or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected a uint8 or float32 (h, w, 3) BGR frame, got {frame.dtype} {frame.shape}")
    shape = frame.shape[:2]
    _, (dw, dh), new_unpad = letterbox_params(shape, new_shape)
    im = torch.from_numpy(np.ascontiguousarray(frame)).to(device).permute(2, 0, 1)
    if shape[::-1] != new_unpad:
        x = F.interpolate(
            im[None].float(), size=(new_unpad[1], new_unpad[0]), mode="bilinear", align_corners=False, antialias=False
        )
        im = x[0] if im.dtype == torch.float32 else x[0].round_().clamp_(0, 255).to(torch.uint8)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    im = F.pad(im, (left, right, top, bottom), value=pad_value)
    return im.flip(0)


def letterbox_image(im: np.ndarray, new_shape: Tuple[int, int] = (640, 640), color: Tuple[int, int, int] = (114, 114, 114),
                    scaleup: bool = True, center: bool = True, stride: int = 32, auto: bool = False):
    """Host numpy letterbox of the data pipeline (counterpart of ``bsyolo_tpu/ops/letterbox.py
    letterbox_image``): ``data/cv.py resize`` (INTER_LINEAR), then the reference's round-0.1 pad
    split filled with ``color``. Returns (image, ratio, (dw, dh))."""
    from bsyolo_tpu_torch.data.cv import resize

    shape = im.shape[:2]
    r, (dw, dh), new_unpad = letterbox_params(shape, new_shape, scaleup, center, stride, auto)
    if shape[::-1] != new_unpad:
        im = resize(im, new_unpad)
    top, bottom = int(round(dh - 0.1)) if center else 0, int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)) if center else 0, int(round(dw + 0.1))
    pad = ((top, bottom), (left, right)) + ((0, 0),) * (im.ndim - 2)
    if im.ndim == 3:
        out = np.empty((im.shape[0] + top + bottom, im.shape[1] + left + right, im.shape[2]), im.dtype)
        out[:] = np.asarray(color, im.dtype)[: im.shape[2]]
        out[top : top + im.shape[0], left : left + im.shape[1]] = im
        return out, r, (dw, dh)
    return np.pad(im, pad, constant_values=color[0]), r, (dw, dh)
