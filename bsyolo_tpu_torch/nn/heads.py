"""Task heads (counterpart of ``bsyolo_tpu/nn/heads.py``): Detect, Segment, Pose, OBB, Classify, v10Detect.

``Detect`` returns raw per-level maps (B, 4 * reg_max + nc, H, W), box
channels first in the side-major DFL layout. ``Segment``, ``Pose`` and ``OBB``
are Detect with extra per-anchor channels after the class logits: 32 (``nm``)
mask coefficients, ``nkpt * ndim`` raw keypoint values, or ``ne`` raw angle
values; ``Segment`` also returns the mask prototypes of ``Proto``. They
inherit Detect, so their box and class branches carry the reference torch
names (``model.23.cv2.0.0``). Decoding is a separate pure function, as in the
JAX package, so the predictor can fuse decode and NMS. ``Classify`` is a
1x1 conv to 1280 channels, global average pooling, dropout in train mode and a
linear layer to the class logits. A ``legacy`` head (the YOLO v3 to v9 graphs,
which have no C3k2) has two 3x3 convs for its class branch in place of the
depthwise-separable stacks. ``v10Detect`` (YOLOv10) carries two Detect
branches, one-to-many (``cv2``/``cv3``) and one-to-one (``one2one_cv2``/
``one2one_cv3``, fed the features detached); ``postprocess_e2e`` selects the
one-to-one head's detections without NMS. ``WorldDetect`` (YOLO-World) keeps
Detect's box branch and scores an embedding branch against the text rows with
a contrastive head (``cv4``): K class logits per anchor, K the text's row count
at run time.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from bsyolo_tpu_torch.kernels.decode import decode_xywh
from bsyolo_tpu_torch.nn.modules import (BNContrastiveHead, ContrastiveHead, Conv, Conv2d, ConvTranspose2d, DWConv,
                                         Linear, dfl_decode)
from bsyolo_tpu_torch.ops.anchors import dist2rbox, make_anchors
from bsyolo_tpu_torch.ops.boxes import xywh2xyxy


class Detect(nn.Module):
    """Anchor-free decoupled head: a box branch (two 3x3 convs, 1x1 to 4 * reg_max)
    and a depthwise-separable class branch per level (``legacy``: two 3x3 convs).
    Its levels are in the graph's compute dtype (bfloat16 levels from the bf16
    graph), contiguous."""

    def __init__(self, nc: int, ch: Tuple[int, ...], strides: Tuple[int, ...], reg_max: int = 16,
                 legacy: bool = False):
        super().__init__()
        self.nc, self.reg_max, self.strides, self.legacy = nc, reg_max, tuple(strides), legacy
        self.cv2, self.cv3 = _box_branch(ch, reg_max), _class_branch(ch, nc, "legacy" if legacy else "dw")

    def bias_init(self) -> None:
        """Box bias 1.0; class bias log(5 / nc / (640 / stride)^2)."""
        _bias_init(self.cv2, self.cv3, self.strides, self.nc)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.cat([self.cv2[i](x), self.cv3[i](x)], 1) for i, x in enumerate(feats)]


def _box_branch(ch: Tuple[int, ...], reg_max: int) -> nn.ModuleList:
    c2 = max(16, ch[0] // 4, reg_max * 4)
    return nn.ModuleList(nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1)) for x in ch)


def _class_branch(ch: Tuple[int, ...], nc: int, kind: str) -> nn.ModuleList:
    """Per level: ``legacy`` two 3x3 convs; ``dw`` (Detect) or ``v10`` (v10Detect) a depthwise 3x3 and a
    1x1 conv, twice, the depthwise one a ``DWConv`` or a grouped ``Conv`` as the JAX package names them;
    then a 1x1 conv to the class logits."""
    c3 = max(ch[0], min(nc, 100))

    def stack(x):
        if kind == "legacy":
            return [Conv(x, c3, 3), Conv(c3, c3, 3)]
        dw = (lambda c: DWConv(c, c, 3)) if kind == "dw" else (lambda c: Conv(c, c, 3, g=c))
        return [nn.Sequential(dw(x), Conv(x, c3, 1)), nn.Sequential(dw(c3), Conv(c3, c3, 1))]

    return nn.ModuleList(nn.Sequential(*stack(x), Conv2d(c3, nc, 1)) for x in ch)


def _bias_init(box: nn.ModuleList, cls: nn.ModuleList, strides, nc: int) -> None:
    with torch.no_grad():
        for a, b, s in zip(box, cls, strides):
            a[-1].bias.fill_(1.0)
            b[-1].bias.fill_(math.log(5 / nc / (640 / s) ** 2))


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

    def __init__(self, nc: int, nm: int, npr: int, ch: Tuple[int, ...], strides: Tuple[int, ...], reg_max: int = 16,
                 legacy: bool = False):
        super().__init__(nc, ch, strides, reg_max, legacy)
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
                 reg_max: int = 16, legacy: bool = False):
        super().__init__(nc, ch, strides, reg_max, legacy)
        self.kpt_shape = tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.cv4 = _extra_branch(ch, max(ch[0] // 4, nk), nk)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        det = super().forward(feats)
        return [torch.cat([d, self.cv4[i](x)], 1) for i, (d, x) in enumerate(zip(det, feats))]


class OBB(Detect):
    """Detect + ``ne`` raw rotation-angle values per anchor; levels (B, 4 * reg_max + nc + ne, H, W)."""

    def __init__(self, nc: int, ne: int, ch: Tuple[int, ...], strides: Tuple[int, ...], reg_max: int = 16,
                 legacy: bool = False):
        super().__init__(nc, ch, strides, reg_max, legacy)
        self.ne = ne
        self.cv4 = _extra_branch(ch, max(ch[0] // 4, ne), ne)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        det = super().forward(feats)
        return [torch.cat([d, self.cv4[i](x)], 1) for i, (d, x) in enumerate(zip(det, feats))]


class WorldDetect(nn.Module):
    """Open-vocabulary head: Detect's box branch (``cv2``), an embedding branch per level (two 3x3 convs, a 1x1
    conv with a bias to ``embed`` channels, ``cv3``) and a contrastive head (``cv4``; BatchNorm on the image side
    with ``with_bn``) scoring it against the text (B, K, embed). Levels (B, 4 * reg_max + K, H, W) in the
    graph's compute dtype; the box bias starts at 1.0."""

    def __init__(self, nc: int, ch: Tuple[int, ...], strides: Tuple[int, ...], embed: int = 512,
                 with_bn: bool = False, reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = _box_branch(ch, reg_max)
        self.cv3 = nn.ModuleList(nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), Conv2d(c3, embed, 1)) for x in ch)
        self.cv4 = nn.ModuleList(BNContrastiveHead(embed) if with_bn else ContrastiveHead() for _ in ch)

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for box in self.cv2:
                box[-1].bias.fill_(1.0)

    def forward(self, feats: Sequence[torch.Tensor], text: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for i, x in enumerate(feats):
            box = self.cv2[i](x)
            out.append(torch.cat([box, self.cv4[i](self.cv3[i](x), text).to(box.dtype)], 1))
        return out


class v10Detect(nn.Module):
    """YOLOv10's NMS-free head: two Detect branches over the same levels, each a box branch and a class
    branch of depthwise 3x3 and 1x1 convs (as Detect's, its depthwise convs plain grouped ``Conv``s).
    The one-to-many branch (``cv2``, ``cv3``) trains with the top-10 assignment; the one-to-one branch
    (``one2one_cv2``, ``one2one_cv3``) is fed the levels detached, so no gradient flows from it into the
    graph (its train-mode BatchNorm still updates its statistics, as JAX's ``stop_gradient`` leaves
    ``batch_stats``), trains with the top-1 assignment and serves predict through ``postprocess_e2e``.
    Returns ``{"one2many": levels, "one2one": levels}``, each (B, 4 * reg_max + nc, H, W) per level."""

    def __init__(self, nc: int, ch: Tuple[int, ...], strides: Tuple[int, ...], reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        self.cv2, self.cv3 = _box_branch(ch, reg_max), _class_branch(ch, nc, "v10")
        self.one2one_cv2, self.one2one_cv3 = _box_branch(ch, reg_max), _class_branch(ch, nc, "v10")

    def bias_init(self) -> None:
        """Both branches: box bias 1.0, class bias log(5 / nc / (640 / stride)^2)."""
        _bias_init(self.cv2, self.cv3, self.strides, self.nc)
        _bias_init(self.one2one_cv2, self.one2one_cv3, self.strides, self.nc)

    def forward(self, feats: Sequence[torch.Tensor]):
        one2many = [torch.cat([self.cv2[i](x), self.cv3[i](x)], 1) for i, x in enumerate(feats)]
        one2one = [torch.cat([self.one2one_cv2[i](x), self.one2one_cv3[i](x)], 1)
                   for i, x in enumerate(f.detach() for f in feats)]
        return {"one2many": one2many, "one2one": one2one}


def postprocess_e2e(preds: torch.Tensor, max_det: int = 300, nc: int = 0) -> torch.Tensor:
    """NMS-free selection from decoded one-to-one predictions (``decode_detections``' (B, A, 4 + nc) xywh
    pixels and sigmoid scores) -> (B, min(max_det, A), 6) rows x1, y1, x2, y2, conf, cls: the k anchors of
    highest best score, then the k highest (anchor, class) scores among them. Both top-k's break ties to
    the lower index, as ``jax.lax.top_k``."""
    b, a, _ = preds.shape
    nc = nc if nc > 0 else preds.shape[-1] - 4
    boxes = xywh2xyxy(preds[..., :4])
    scores = preds[..., 4:]
    k = min(max_det, a)
    idx = torch.sort(scores.amax(-1), dim=1, descending=True, stable=True).indices[:, :k]  # (B, k)
    boxes = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    sub = scores.gather(1, idx[..., None].expand(-1, -1, scores.shape[-1]))
    conf, flat = torch.sort(sub.reshape(b, -1), dim=1, descending=True, stable=True)
    conf, flat = conf[:, :k], flat[:, :k]
    out_boxes = boxes.gather(1, (flat // nc)[..., None].expand(-1, -1, 4))
    return torch.cat([out_boxes, conf[..., None], (flat % nc).to(preds.dtype)[..., None]], -1)


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
