"""YOLO-NAS blocks (counterpart of ``bsyolo_tpu/nn/modules_nas.py``).

The JAX package rebuilds the YOLO-NAS graph from the public super-gradients
architecture description (``cfg/models/nas/yolo_nas_{s,m,l}.yaml``); these are
the same blocks in NCHW. Names follow the JAX modules (``branch_3x3``,
``post_bn``, ``reduce_skip1``, ``cls_pred``), with the CSP layer's bottlenecks
as ``bottlenecks.{i}.cv1`` (``bottlenecks_{i}_cv1`` in JAX, ``utils/weights.py``)
and the head's per-level convs as lists (``stem.{i}``, ``cls_convs.{i}``, ...).

Every ``Conv`` with an activation takes the graph's (the YAML's
``activation: nn.ReLU()``); ``QARepVGGBlock`` ends in its own ReLU. The head
has 17 DFL bins and lays each level out as the Detect heads do, box
distributions first: (B, 4 * 17 + nc, H, W).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from bsyolo_tpu_torch.nn.modules import BN_EPS, BN_MOMENTUM, BatchNorm2d, Conv, Conv2d, ConvTranspose2d

NAS_REG_MAX = 17  # DFL bins of the head (YOLO-NAS's "reg_max 16" counts bin edges)


class QARepVGGBlock(nn.Module):
    """ReLU(post_bn(BN(conv3x3(x)) + conv1x1(x) + x)): the 3x3 branch a Conv without activation, the 1x1 branch
    a plain conv with a bias, the identity only where the widths agree and the stride is 1."""

    def __init__(self, c1: int, c2: int, s: int = 1):
        super().__init__()
        self.identity = c1 == c2 and s == 1
        self.branch_3x3 = Conv(c1, c2, 3, s, act=False)
        self.branch_1x1 = Conv2d(c1, c2, 1, s, bias=True)
        self.post_bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.branch_3x3(x) + self.branch_1x1(x)
        if self.identity:
            y = y + x
        return torch.relu(self.post_bn(y))


class _Bottleneck(nn.Module):
    """Two QARepVGG blocks, added to their input."""

    def __init__(self, c: int):
        super().__init__()
        self.cv1 = QARepVGGBlock(c, c)
        self.cv2 = QARepVGGBlock(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.cv2(self.cv1(x))


class YoloNASCSPLayer(nn.Module):
    """Two 1x1 reductions to ``hidden``; ``n`` bottlenecks on the first; the last bottleneck's output (with
    ``concat_intermediates``: every bottleneck's, then the first reduction) and the second reduction concatenated
    into a 1x1 conv."""

    def __init__(self, c1: int, c2: int, n: int, hidden: int, concat_intermediates: bool = False):
        super().__init__()
        self.concat_intermediates = concat_intermediates
        self.conv1 = Conv(c1, hidden, 1, 1)
        self.conv2 = Conv(c1, hidden, 1, 1)
        self.bottlenecks = nn.ModuleList(_Bottleneck(hidden) for _ in range(n))
        self.conv3 = Conv(hidden * ((n + 1 if concat_intermediates else 1) + 1), c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.conv1(x)]
        for m in self.bottlenecks:
            outs.append(m(outs[-1]))
        cat = outs[1:] + [outs[0]] if self.concat_intermediates else [outs[-1]]
        return self.conv3(torch.cat(cat + [self.conv2(x)], 1))


class YoloNASStem(nn.Module):
    """One stride-2 QARepVGG block."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = QARepVGGBlock(c1, c2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class YoloNASStage(nn.Module):
    """A stride-2 QARepVGG block, then a CSP layer."""

    def __init__(self, c1: int, c2: int, n: int, hidden: int, concat_intermediates: bool = False):
        super().__init__()
        self.downsample = QARepVGGBlock(c1, c2, 2)
        self.blocks = YoloNASCSPLayer(c2, c2, n, hidden, concat_intermediates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class NASUpMerge(nn.Module):
    """Inputs (pre, skip1, skip2): ``pre`` upsampled 2x (a 2x2 stride-2 transposed conv with a bias), ``skip1``
    reduced by a 1x1 conv, ``skip2`` (two strides shallower) reduced and brought down by a stride-2 3x3 conv; the
    three concatenated, reduced by a 1x1 conv, then a CSP layer."""

    def __init__(self, ch: Tuple[int, int, int], c2: int, n: int, hidden: int):
        super().__init__()
        self.upsample = ConvTranspose2d(ch[0], c2, 2, 2, 0, bias=True)
        self.reduce_skip1 = Conv(ch[1], c2, 1, 1)
        self.reduce_skip2 = Conv(ch[2], c2, 1, 1)
        self.downsample_skip2 = Conv(c2, c2, 3, 2)
        self.reduce_after_concat = Conv(3 * c2, c2, 1, 1)
        self.blocks = YoloNASCSPLayer(c2, c2, n, hidden)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        pre, skip1, skip2 = xs
        x = torch.cat([self.upsample(pre), self.reduce_skip1(skip1),
                       self.downsample_skip2(self.reduce_skip2(skip2))], 1)
        return self.blocks(self.reduce_after_concat(x))


class NASDown(nn.Module):
    """Inputs (x, skip): a stride-2 3x3 conv of ``x`` to c2 / 2, concatenated with ``skip``, then a CSP layer."""

    def __init__(self, ch: Tuple[int, int], c2: int, n: int, hidden: int):
        super().__init__()
        self.conv = Conv(ch[0], c2 // 2, 3, 2)
        self.blocks = YoloNASCSPLayer(c2 // 2 + ch[1], c2, n, hidden)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        x, skip = xs
        return self.blocks(torch.cat([self.conv(x), skip], 1))


class NASDetect(nn.Module):
    """Per level: a 1x1 stem to ``inter[i]``, then a class tower (3x3 conv, 1x1 conv with a bias to nc, the bias
    -log(99): an untrained head scores 0.01) and a box tower (3x3 conv, 1x1 conv with a bias to 4 * 17); the
    level is (B, 4 * 17 + nc, H, W), box distributions first."""

    def __init__(self, nc: int, ch: Tuple[int, ...], strides: Tuple[int, ...], inter: Tuple[int, ...] = (64, 128, 256)):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, NAS_REG_MAX, tuple(strides)
        self.stem = nn.ModuleList(Conv(x, c, 1, 1) for x, c in zip(ch, inter))
        self.cls_convs = nn.ModuleList(Conv(c, c, 3, 1) for c in inter[:len(ch)])
        self.cls_pred = nn.ModuleList(Conv2d(c, nc, 1, bias=True) for c in inter[:len(ch)])
        self.reg_convs = nn.ModuleList(Conv(c, c, 3, 1) for c in inter[:len(ch)])
        self.reg_pred = nn.ModuleList(Conv2d(c, 4 * NAS_REG_MAX, 1, bias=True) for c in inter[:len(ch)])

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for m in self.cls_pred:
                m.bias.fill_(-math.log((1 - 1e-2) / 1e-2))

    def forward(self, feats: Sequence[torch.Tensor]):
        out = []
        for i, x in enumerate(feats):
            x = self.stem[i](x)
            out.append(torch.cat([self.reg_pred[i](self.reg_convs[i](x)), self.cls_pred[i](self.cls_convs[i](x))], 1))
        return out
