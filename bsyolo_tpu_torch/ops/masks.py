"""Mask ops of instance segmentation (counterpart of ``bsyolo_tpu/ops/masks.py``).

Masks are ``sigmoid(coefficients . prototypes)``, cut to each box and resized
bilinearly. The resize follows ``jax.image.resize``: half-pixel centres and,
when it shrinks, a triangle filter as wide as the scale (PyTorch's antialiased
bilinear), which equals plain bilinear interpolation when it enlarges.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(n, H, W) masks with the pixels outside each (n, 4) xyxy box (mask pixels) set to 0:
    a pixel (r, c) is kept where x1 <= c < x2 and y1 <= r < y2."""
    n, h, w = masks.shape
    x1, y1, x2, y2 = boxes[:, :, None].unbind(1)  # each (n, 1)
    c = torch.arange(w, device=masks.device, dtype=boxes.dtype)[None, None, :]
    r = torch.arange(h, device=masks.device, dtype=boxes.dtype)[None, :, None]
    keep = (c >= x1[..., None]) & (c < x2[..., None]) & (r >= y1[..., None]) & (r < y2[..., None])
    return masks * keep


def resize_masks(masks: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(n, H, W) float masks -> (n, h, w), ``size`` = (h, w): ``jax.image.resize`` bilinear."""
    if masks.shape[0] == 0:
        return masks.new_zeros((0, *size))
    return F.interpolate(masks[None], size=tuple(size), mode="bilinear", align_corners=False, antialias=True)[0]


def process_mask(proto: torch.Tensor, coeffs: torch.Tensor, boxes_xyxy: torch.Tensor, img_hw: Tuple[int, int],
                 upsample: bool = True) -> torch.Tensor:
    """(nm, Hm, Wm) prototypes, (n, nm) coefficients and (n, 4) xyxy boxes in network-input
    pixels -> (n, H, W) float32 masks in [0, 1]: sigmoid of the product at prototype size,
    cut to the boxes there, then resized to ``img_hw`` (unless ``upsample`` is False)."""
    nm, hm, wm = proto.shape
    masks = torch.sigmoid(torch.einsum("chw,nc->nhw", proto.float(), coeffs.float()))
    ih, iw = img_hw
    scale = torch.tensor([wm / iw, hm / ih, wm / iw, hm / ih], dtype=torch.float32, device=proto.device)
    masks = crop_mask(masks, boxes_xyxy.float() * scale)
    return resize_masks(masks, (ih, iw)) if upsample else masks


def scale_masks(masks: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """(n, H, W) masks resized to ``target_hw``, bilinear as ``jax.image.resize``."""
    return resize_masks(masks.float(), target_hw)


def resize_linear(masks: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(n, H, W) float masks -> (n, h, w), ``size`` = (h, w): ``cv2.resize`` INTER_LINEAR on float
    images (half-pixel centres, two taps per axis, edges clamped, no antialiasing), on the
    masks' device."""
    if masks.shape[0] == 0:
        return masks.new_zeros((0, *size))
    return F.interpolate(masks[None].float(), size=tuple(size), mode="bilinear", align_corners=False)[0]
