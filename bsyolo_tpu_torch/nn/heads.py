"""Detect head (counterpart of ``bsyolo_tpu/nn/heads.py``).

``Detect`` returns raw per-level maps (B, 4 * reg_max + nc, H, W), box
channels first in the side-major DFL layout. Decoding is a separate pure
function, as in the JAX package, so the predictor can fuse decode and NMS.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from bsyolo_tpu_torch.nn.modules import Conv, DWConv, dfl_decode
from bsyolo_tpu_torch.ops.anchors import dist2bbox, make_anchors


class Detect(nn.Module):
    """Anchor-free decoupled head: a box branch (two 3x3 convs, 1x1 to 4 * reg_max)
    and a depthwise-separable class branch per level."""

    def __init__(self, nc: int, ch: Tuple[int, ...], strides: Tuple[int, ...], reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1)) for x in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                nn.Conv2d(c3, nc, 1),
            )
            for x in ch
        )

    def bias_init(self) -> None:
        """Box bias 1.0; class bias log(5 / nc / (640 / stride)^2)."""
        with torch.no_grad():
            for a, b, s in zip(self.cv2, self.cv3, self.strides):
                a[-1].bias.fill_(1.0)
                b[-1].bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.cat([self.cv2[i](x), self.cv3[i](x)], 1) for i, x in enumerate(feats)]


def flatten_levels(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, no, H, W) maps -> (B, no, A), anchors level-major then h * W + w."""
    b, no = feats[0].shape[:2]
    return torch.cat([f.reshape(b, no, -1) for f in feats], 2)


def decode_detections(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = 16) -> torch.Tensor:
    """Raw Detect maps -> (B, A, 4 + nc): xywh pixels + sigmoid scores."""
    anchors, stride_t = make_anchors([f.shape[2:] for f in feats], strides, 0.5, device=feats[0].device)
    flat = flatten_levels(feats).transpose(1, 2)  # (B, A, no)
    dist = dfl_decode(flat[..., : 4 * reg_max], reg_max)
    dbox = dist2bbox(dist, anchors[None], xywh=True) * stride_t[None]
    return torch.cat([dbox, torch.sigmoid(flat[..., 4 * reg_max : 4 * reg_max + nc].float())], -1)
