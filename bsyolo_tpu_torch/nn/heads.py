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

from bsyolo_tpu_torch.kernels.decode import decode_xywh
from bsyolo_tpu_torch.nn.modules import Conv, Conv2d, DWConv


class Detect(nn.Module):
    """Anchor-free decoupled head: a box branch (two 3x3 convs, 1x1 to 4 * reg_max)
    and a depthwise-separable class branch per level. Its levels are in the
    graph's compute dtype (bfloat16 levels from the bf16 graph), contiguous."""

    def __init__(self, nc: int, ch: Tuple[int, ...], strides: Tuple[int, ...], reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1)) for x in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                Conv2d(c3, nc, 1),
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


def decode_detections(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = 16) -> torch.Tensor:
    """Raw Detect maps -> (B, A, 4 + nc): xywh pixels + sigmoid scores.

    The decode is one launch of the CUDA kernel (kernels/decode.py
    ``decode_xywh``) for CUDA maps, which reads the levels in place, and its
    plain version for CPU maps. The kernel is specialised to 16 DFL bins, so
    ``reg_max != 16`` decodes with the plain version on either device.
    Channels past ``4 * reg_max + nc`` are ignored.
    """
    return decode_xywh(feats, strides, nc, reg_max)
