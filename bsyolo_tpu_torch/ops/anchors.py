"""Anchor-free grid utilities (counterpart of ``bsyolo_tpu/ops/anchors.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    grid_cell_offset: float = 0.5,
    device=None,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenated grid-cell centres (A, 2) in feature units and strides (A, 1).

    Anchors run level by level, row-major within a level (h * W + w), so
    anchor ``a`` is the same cell in both packages.
    """
    points, stride_t = [], []
    for (h, w), stride in zip(feat_shapes, strides):
        sx = torch.arange(w, device=device, dtype=dtype) + grid_cell_offset
        sy = torch.arange(h, device=device, dtype=dtype) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack((gx, gy), -1).reshape(-1, 2))
        stride_t.append(torch.full((h * w, 1), float(stride), device=device, dtype=dtype))
    return torch.cat(points), torch.cat(stride_t)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True, dim: int = -1) -> torch.Tensor:
    """(l, t, r, b) distances around anchor points -> xywh or xyxy boxes."""
    lt, rb = distance.chunk(2, dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat(((x1y1 + x2y2) / 2, x2y2 - x1y1), dim)
    return torch.cat((x1y1, x2y2), dim)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances from the anchor points, clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat((anchor_points - x1y1, x2y2 - anchor_points), -1).clamp(0, reg_max - 0.01)


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor, anchor_points: torch.Tensor,
              dim: int = -1) -> torch.Tensor:
    """(l, t, r, b) distances in the box's own frame and its angle -> x, y, w, h: the centre offset
    ``(r - l, b - t) / 2`` rotated by the angle around the anchor point, the size ``l + r, t + b``."""
    lt, rb = pred_dist.chunk(2, dim)
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    xf, yf = ((rb - lt) / 2).chunk(2, dim)
    x, y = xf * cos - yf * sin, xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], dim) + anchor_points, lt + rb], dim)
