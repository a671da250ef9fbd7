"""Box geometry (counterpart of ``bsyolo_tpu/ops/boxes.py``).

All functions act on the last axis of size 4 and broadcast over leading dims.
"""

from __future__ import annotations

from typing import Tuple

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = x.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def clip_boxes(boxes: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to image bounds ``shape=(h, w)``."""
    h, w = shape
    hi = torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(boxes.clamp(min=0), hi)


def scale_boxes(
    img1_shape: Tuple[int, int],
    boxes: torch.Tensor,
    img0_shape: Tuple[int, int],
    ratio_pad=None,
    padding: bool = True,
) -> torch.Tensor:
    """Rescale xyxy boxes from letterboxed ``img1_shape`` back to ``img0_shape``
    (gain/pad inversion with the letterbox's 0.1 round offset)."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad_w = round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1)
        pad_h = round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1)
    else:
        gain = ratio_pad[0][0]
        pad_w, pad_h = ratio_pad[1]
    if padding:
        boxes = boxes - torch.tensor([pad_w, pad_h, pad_w, pad_h], dtype=boxes.dtype, device=boxes.device)
    return clip_boxes(boxes / gain, img0_shape)


def box_iou_pairwise(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    a1, a2 = box1[..., :, None, :2], box1[..., :, None, 2:]
    b1, b2 = box2[..., None, :, :2], box2[..., None, :, 2:]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (a2 - a1).prod(-1)
    area2 = (b2 - b1).prod(-1)
    return inter / (area1 + area2 - inter + eps)
