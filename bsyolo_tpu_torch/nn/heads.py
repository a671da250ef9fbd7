"""Task heads (counterpart of ``bsyolo_tpu/nn/heads.py``): Detect, Segment, Pose, OBB, Classify.

``Detect`` returns raw per-level maps (B, 4 * reg_max + nc, H, W), box
channels first in the side-major DFL layout. ``Segment``, ``Pose`` and ``OBB``
are Detect with extra per-anchor channels after the class logits: 32 (``nm``)
mask coefficients, ``nkpt * ndim`` raw keypoint values, or ``ne`` raw angle
values; ``Segment`` also returns the mask prototypes of ``Proto``. They
inherit Detect, so their box and class branches carry the reference torch
names (``model.23.cv2.0.0``). Decoding is a separate pure function, as in the
JAX package, so the predictor can fuse decode and NMS. ``Classify`` is a
1x1 conv to 1280 channels, global average pooling, dropout in train mode and a
linear layer to the class logits.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from bsyolo_tpu_torch.kernels.decode import decode_xywh
from bsyolo_tpu_torch.nn.modules import Conv, Conv2d, ConvTranspose2d, DWConv, Linear, dfl_decode
from bsyolo_tpu_torch.ops.anchors import dist2rbox, make_anchors


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


class Proto(nn.Module):
    """Mask prototypes: Conv 3x3, a 2x2 stride-2 transposed convolution with bias (2x
    upsample), Conv 3x3, Conv 1x1 to ``c2`` prototypes (reference ``Proto``)."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def _extra_branch(ch: Tuple[int, ...], c4: int, n: int) -> nn.ModuleList:
    return nn.ModuleList(nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), Conv2d(c4, n, 1)) for x in ch)


class Segment(Detect):
    """Detect + ``nm`` mask coefficients per anchor + ``Proto`` on the first level. Returns
    ``{"feats": levels (B, 4 * reg_max + nc + nm, H, W), "proto": (B, nm, 2 H0, 2 W0)}``."""

    def __init__(self, nc: int, nm: int, npr: int, ch: Tuple[int, ...], strides: Tuple[int, ...], reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        self.cv4 = _extra_branch(ch, max(ch[0] // 4, nm), nm)

    def forward(self, feats: Sequence[torch.Tensor]):
        proto = self.proto(feats[0])
        det = super().forward(feats)
        return {"feats": [torch.cat([d, self.cv4[i](x)], 1) for i, (d, x) in enumerate(zip(det, feats))],
                "proto": proto}


class Pose(Detect):
    """Detect + ``nkpt * ndim`` raw keypoint values per anchor; levels (B, 4 * reg_max + nc + nk, H, W)."""

    def __init__(self, nc: int, kpt_shape: Tuple[int, int], ch: Tuple[int, ...], strides: Tuple[int, ...],
                 reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.kpt_shape = tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.cv4 = _extra_branch(ch, max(ch[0] // 4, nk), nk)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        det = super().forward(feats)
        return [torch.cat([d, self.cv4[i](x)], 1) for i, (d, x) in enumerate(zip(det, feats))]


class OBB(Detect):
    """Detect + ``ne`` raw rotation-angle values per anchor; levels (B, 4 * reg_max + nc + ne, H, W)."""

    def __init__(self, nc: int, ne: int, ch: Tuple[int, ...], strides: Tuple[int, ...], reg_max: int = 16):
        super().__init__(nc, ch, strides, reg_max)
        self.ne = ne
        self.cv4 = _extra_branch(ch, max(ch[0] // 4, ne), ne)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        det = super().forward(feats)
        return [torch.cat([d, self.cv4[i](x)], 1) for i, (d, x) in enumerate(zip(det, feats))]


class Classify(nn.Module):
    """Conv 1x1 to 1280 channels, global average pooling, dropout at ``dropout`` in train mode, a linear
    layer to ``c2`` class logits (B, c2). The dropout draws from ``generator``, which the train step sets
    (``engine/train_step.py``); a train-mode forward with dropout and no generator raises."""

    def __init__(self, c1: int, c2: int, dropout: float = 0.0):
        super().__init__()
        self.conv = Conv(c1, 1280, 1, 1)
        self.linear = Linear(1280, c2)
        self.dropout = float(dropout)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x).mean((2, 3))
        if self.training and self.dropout > 0:
            if self.generator is None:
                raise RuntimeError("Classify dropout in train mode needs a torch.Generator (Classify.generator)")
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - self.dropout
            x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        return self.linear(x)


def decode_extras(feats: Sequence[torch.Tensor], nc: int, reg_max: int = 16) -> torch.Tensor:
    """The per-anchor channels past ``4 * reg_max + nc`` (mask coefficients, raw keypoints) of
    per-level (B, no, H, W) maps -> (B, A, no - 4 * reg_max - nc), anchors level-major."""
    base = 4 * reg_max + nc
    b = feats[0].shape[0]
    return torch.cat([f[:, base:].reshape(b, f.shape[1] - base, -1) for f in feats], 2).transpose(1, 2)


def gather_anchors(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, A, ...) per-anchor values -> (B, max_det, ...) those of each row's source anchor ``idx``
    (``detect_postprocess(return_idx=True)``), zeros on the padding rows (idx -1)."""
    shape = (*idx.shape, *[1] * (values.ndim - 2))
    rows = values.gather(1, idx.clamp(min=0).reshape(shape).expand(*idx.shape, *values.shape[2:]))
    return rows * (idx >= 0).reshape(shape)


def decode_keypoints(kpts_flat: torch.Tensor, feats: Sequence[torch.Tensor], strides: Sequence[int],
                     kpt_shape: Tuple[int, int] = (17, 3)) -> torch.Tensor:
    """(B, A, nk) raw keypoints -> (B, A, nkpt, ndim) float32: x, y in pixels
    (``(raw * 2 + anchor - 0.5) * stride``), visibility through a sigmoid."""
    anchors, stride_t = make_anchors([f.shape[2:] for f in feats], strides, 0.5, device=kpts_flat.device)
    b, a, _ = kpts_flat.shape
    nkpt, ndim = kpt_shape
    k = kpts_flat.reshape(b, a, nkpt, ndim).float()
    xy = (k[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]
    return torch.cat([xy, torch.sigmoid(k[..., 2:3])], -1) if ndim == 3 else xy


def decode_detections(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = 16) -> torch.Tensor:
    """Raw Detect maps -> (B, A, 4 + nc): xywh pixels + sigmoid scores.

    The decode is one launch of the CUDA kernel (kernels/decode.py
    ``decode_xywh``) for CUDA maps, which reads the levels in place, and its
    plain version for CPU maps. The kernel is specialised to 16 DFL bins, so
    ``reg_max != 16`` decodes with the plain version on either device.
    Channels past ``4 * reg_max + nc`` are ignored.
    """
    return decode_xywh(feats, strides, nc, reg_max)


def decode_obb(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = 16,
               ne: int = 1) -> torch.Tensor:
    """Raw OBB maps -> (B, A, 4 + nc + 1) float32: x, y, w, h in pixels, sigmoid scores, angle in radians
    (``(sigmoid(raw) - 0.25) * pi``), the box decoded around its angle (``dist2rbox``)."""
    anchors, stride_t = make_anchors([f.shape[2:] for f in feats], strides, 0.5, device=feats[0].device)
    b = feats[0].shape[0]
    flat = torch.cat([f.reshape(b, f.shape[1], -1) for f in feats], 2).transpose(1, 2).float()
    base = 4 * reg_max + nc
    angle = (torch.sigmoid(flat[..., base : base + ne]) - 0.25) * math.pi
    rbox = dist2rbox(dfl_decode(flat[..., : 4 * reg_max], reg_max), angle, anchors[None]) * stride_t[None]
    return torch.cat([rbox, torch.sigmoid(flat[..., 4 * reg_max : base]), angle], -1)
