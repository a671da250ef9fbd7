"""Box geometry (counterpart of ``bsyolo_tpu/ops/boxes.py``).

All functions act on the last axis of size 4 and broadcast over leading dims.
"""

from __future__ import annotations

import math
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


def inner_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, eps: float = 1e-7,
              ratio: float = 0.7) -> torch.Tensor:
    """Inner-IoU: the IoU of both boxes shrunk about their centres by ``ratio``; (..., 1)."""
    if not xywh:
        box1, box2 = xyxy2xywh(box1), xyxy2xywh(box2)
    x1, y1, w1, h1 = box1.chunk(4, -1)
    x2, y2, w2, h2 = box2.chunk(4, -1)
    b1x1, b1x2 = x1 - w1 * ratio / 2, x1 + w1 * ratio / 2
    b1y1, b1y2 = y1 - h1 * ratio / 2, y1 + h1 * ratio / 2
    b2x1, b2x2 = x2 - w2 * ratio / 2, x2 + w2 * ratio / 2
    b2y1, b2y2 = y2 - h2 * ratio / 2, y2 + h2 * ratio / 2
    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) * (
        torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)
    ).clamp(min=0)
    union = w1 * h1 * ratio * ratio + w2 * h2 * ratio * ratio - inter + eps
    return inter / union


def bbox_iou(
    box1: torch.Tensor,
    box2: torch.Tensor,
    xywh: bool = True,
    GIoU: bool = False,
    DIoU: bool = False,
    CIoU: bool = False,
    SIoU: bool = False,
    MDPIoU: bool = False,
    Inner_iou: bool = False,
    feat_h: float = 640.0,
    feat_w: float = 640.0,
    eps: float = 1e-7,
    ratio: float = 0.7,
) -> torch.Tensor:
    """Elementwise IoU family over broadcastable box tensors; (..., 1).

    The fork's extended ``bbox_iou`` with its quirks, as the JAX package has
    them: in xyxy mode only the heights get the ``+ eps``, and CIoU's aspect
    weight ``alpha`` carries no gradient.
    """
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, -1)
        x2, y2, w2, h2 = box2.chunk(4, -1)
        b1x1, b1x2, b1y1, b1y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2x1, b2x2, b2y1, b2y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1x1, b1y1, b1x2, b1y2 = box1.chunk(4, -1)
        b2x1, b2y1, b2x2, b2y2 = box2.chunk(4, -1)
        w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
        w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps

    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0) * (
        torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)
    ).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    def inner(iou):
        return inner_iou(box1, box2, xywh=xywh, ratio=ratio) if Inner_iou else iou

    if CIoU or DIoU or GIoU or SIoU:
        cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
        ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
        if CIoU or DIoU or SIoU:
            c2 = cw**2 + ch**2 + eps
            rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
            if CIoU:
                v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
                with torch.no_grad():
                    alpha = v / (v - iou + (1 + eps))
                return inner(iou) - (rho2 / c2 + v * alpha)
            if SIoU:
                s_cw = (b2x1 + b2x2 - b1x1 - b1x2) * 0.5 + eps
                s_ch = (b2y1 + b2y2 - b1y1 - b1y2) * 0.5 + eps
                sigma = torch.sqrt(s_cw**2 + s_ch**2)
                sin_a1 = s_cw.abs() / sigma
                sin_a2 = s_ch.abs() / sigma
                sin_a = torch.where(sin_a1 > 2**0.5 / 2, sin_a2, sin_a1)
                angle_cost = torch.cos(torch.arcsin(sin_a) * 2 - math.pi / 2)
                gamma = angle_cost - 2
                distance_cost = 2 - torch.exp(gamma * (s_cw / cw) ** 2) - torch.exp(gamma * (s_ch / ch) ** 2)
                omiga_w = (w1 - w2).abs() / torch.maximum(w1, w2)
                omiga_h = (h1 - h2).abs() / torch.maximum(h1, h2)
                shape_cost = (1 - torch.exp(-omiga_w)) ** 4 + (1 - torch.exp(-omiga_h)) ** 4
                return inner(iou) - 0.5 * (distance_cost + shape_cost) + eps
            return inner(iou) - rho2 / c2  # DIoU
        c_area = cw * ch + eps
        return inner(iou) - (c_area - union) / c_area  # GIoU
    if MDPIoU:
        d1 = (b2x1 - b1x1) ** 2 + (b2y1 - b1y1) ** 2
        d2 = (b2x2 - b1x2) ** 2 + (b2y2 - b1y2) ** 2
        hw2 = feat_h**2 + feat_w**2
        return inner(iou) - d1 / hw2 - d2 / hw2
    return inner(iou)


def wasserstein_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7,
                     constant: float = 12.8) -> torch.Tensor:
    """Normalized Wasserstein (NWD) similarity of xyxy boxes; (..., 1)."""
    b1x1, b1y1, b1x2, b1y2 = pred.chunk(4, -1)
    b2x1, b2y1, b2x2, b2y2 = target.chunk(4, -1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    cx1, cy1 = (b1x1 + b1x2) / 2, (b1y1 + b1y2) / 2
    cx2, cy2 = (b2x1 + b2x2) / 2, (b2y1 + b2y2) / 2
    center_distance = (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2 + eps
    wh_distance = ((w1 - w2) ** 2 + (h1 - h2) ** 2) / 4
    return torch.exp(-torch.sqrt(center_distance + wh_distance) / constant)
