"""Blocks of the BS-YOLO detection graph (counterpart of ``bsyolo_tpu/nn/modules.py``).

NCHW PyTorch modules that carry the reference torch parameter names, so a
``state_dict`` here lines up key for key with the JAX package's variables
through ``utils/weights.py``. BatchNorm uses eps 1e-3 and momentum 0.03 like
the reference; convolution weights are drawn from torch's default
kaiming-uniform, U(+-1/sqrt(fan_in)), and biases start at zero, as in the JAX
package (``TORCH_INIT``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

BN_MOMENTUM = 0.03
BN_EPS = 1e-3


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """Same-shape padding."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv weight from U(+-1/sqrt(fan_in)) with ``generator``; zero
    conv biases; norms start at identity; ELA's fusion weights at zero."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()
        elif isinstance(m, ELA):
            with torch.no_grad():
                for p in (m.ch_weight, m.sp_weight, m.res_weight):
                    p.zero_()


class Conv(nn.Module):
    """Conv2d + BatchNorm + SiLU (reference ``Conv``)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None, g: int = 1, d: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class DWConv(Conv):
    """Depthwise Conv + BN + SiLU, groups = gcd(c1, c2) (reference ``DWConv``)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1, act: bool = True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k: Tuple[int, int] = (3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convolutions, fast variant; ``inner(c)`` builds each inner block."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5,
                 inner: Optional[Callable[[int], nn.Module]] = None):
        super().__init__()
        self.c = int(c2 * e)
        inner = inner or (lambda c: Bottleneck(c, c, shortcut, g, k=(3, 3), e=1.0))
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(inner(self.c) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions; ``inner(c)`` builds each inner block."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 inner: Optional[Callable[[int], nn.Module]] = None):
        super().__init__()
        c_ = int(c2 * e)
        inner = inner or (lambda c: Bottleneck(c, c, shortcut, g, k=(1, 3), e=1.0))
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(inner(c_) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    """C3 whose bottlenecks use a k x k kernel."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5, k: int = 3):
        super().__init__(c1, c2, n, shortcut, g, e, inner=lambda c: Bottleneck(c, c, shortcut, g, k=(k, k), e=1.0))


class C3k2(C2f):
    """C2f whose inner blocks are C3k(n=2) or Bottleneck."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5, g: int = 1,
                 shortcut: bool = True):
        def inner(c):
            return C3k(c, c, 2, shortcut, g) if c3k else Bottleneck(c, c, shortcut, g, k=(3, 3), e=0.5)

        super().__init__(c1, c2, n, shortcut, g, e, inner=inner)


class PMSFA(nn.Module):
    """Progressive multi-scale feature aggregation (fork block): 3x3 conv, half
    through a 5x5 depthwise conv, a quarter through a 7x7 one, 1x1 mix + residual."""

    def __init__(self, inc: int):
        super().__init__()
        self.conv1 = Conv(inc, inc, 3)
        self.conv2 = Conv(inc // 2, inc // 2, 5, g=inc // 2)
        self.conv3 = Conv(inc // 4, inc // 4, 7, g=inc // 4)
        self.conv4 = Conv(inc, inc, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1a, c1b = self.conv1(x).chunk(2, 1)
        c2a, c2b = self.conv2(c1a).chunk(2, 1)
        c3 = self.conv3(c2a)
        return self.conv4(torch.cat([c3, c2b, c1b], 1)) + x


class C3k_gai(C3):
    """C3 whose inner blocks are PMSFA (fork block)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, inner=PMSFA)


class C3k2_gai(C2f):
    """C2f whose inner blocks are C3k_gai(n=2) or PMSFA (fork block)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5, g: int = 1,
                 shortcut: bool = True):
        def inner(c):
            return C3k_gai(c, c, 2, shortcut, g) if c3k else PMSFA(c)

        super().__init__(c1, c2, n, shortcut, g, e, inner=inner)


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained k x k max pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.m = nn.MaxPool2d(k, 1, k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(self.m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SCDown(nn.Module):
    """Separable-conv downsampling: 1x1 conv, then a strided depthwise conv."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x))


class Attention(nn.Module):
    """Multi-head self-attention over the flattened map; qkv/proj are 1x1 convs,
    ``pe`` a 3x3 depthwise positional conv on v.

    The qkv channels decompose as (heads, 2 * key_dim + head_dim), head-major,
    exactly as the JAX package's NHWC reshape reads them.
    """

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        h = dim + self.key_dim * num_heads * 2
        self.qkv = Conv(dim, h, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        kd = self.key_dim
        qkv = self.qkv(x).view(B, self.num_heads, 2 * kd + self.head_dim, H * W)
        q, k, v = qkv.split([kd, kd, self.head_dim], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * self.scale).softmax(dim=-1)  # (B, heads, N, N)
        out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSABlock(nn.Module):
    """Attention + conv FFN, each with a shortcut."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        self.attn = Attention(c, num_heads, attn_ratio)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x) if self.add else self.attn(x)
        return x + self.ffn(x) if self.add else self.ffn(x)


class C2PSA(nn.Module):
    """CSP wrapper around n PSABlocks."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, 0.5, max(1, self.c // 64)) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


def _dw(d: int, k: Tuple[int, int]) -> nn.Conv2d:
    return nn.Conv2d(d, d, k, padding=(k[0] // 2, k[1] // 2), groups=d, bias=True)


class _SE(nn.Module):
    """One branch gate of MSCAAttention: a 1x1 conv on the pooled map (``SEn.conv.0``)."""

    def __init__(self, d: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(d, d, 1))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.conv(t.mean((2, 3), keepdim=True))


class MSCAAttention(nn.Module):
    """Multi-scale strip-conv attention with per-branch SE gating (fork block).

    A 5x5 depthwise base, strip-conv branches of 5, 7 and 11 taps through one
    shared 1x1 depthwise ``dilconv``, a 21-tap branch without it; branch
    weights are softmax(sigmoid(SE)) over the four branches; a 1x1 mix gates the input.
    """

    def __init__(self, dim: int):
        super().__init__()
        d = dim
        self.conv0 = _dw(d, (5, 5))
        for name, k in (("conv0", 5), ("conv1", 7), ("conv2", 11), ("conv3", 21)):
            setattr(self, f"{name}_1", _dw(d, (1, k)))
            setattr(self, f"{name}_2", _dw(d, (k, 1)))
        self.dilconv = nn.Conv2d(d, d, 1, groups=d, bias=True)
        self.SE1, self.SE2, self.SE3, self.SE4 = (_SE(d) for _ in range(4))
        self.conv4 = nn.Conv2d(d, d, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.conv0(x)
        a0 = self.dilconv(self.conv0_2(self.conv0_1(attn)))
        a1 = self.dilconv(self.conv1_2(self.conv1_1(attn)))
        a2 = self.dilconv(self.conv2_2(self.conv2_1(attn)))
        a3 = self.conv3_2(self.conv3_1(attn))
        w = torch.stack([self.SE1(a0), self.SE2(a1), self.SE3(a2), self.SE4(a3)], 0)  # (4, B, C, 1, 1)
        w = torch.sigmoid(w).softmax(dim=0)
        return self.conv4(w[0] * a0 + w[1] * a1 + w[2] * a2 + w[3] * a3) * x


class ELA(nn.Module):
    """Efficient local attention, fork variant.

    Channel branch: pooled map -> depthwise Conv1d -> sigmoid. Spatial branch:
    row and column means through ONE shared dilated depthwise Conv1d and ONE
    shared GroupNorm (C // 16 groups) -> sigmoid -> outer product. A learned
    sigmoid-gated fusion plus a residual.
    """

    def __init__(self, channel: int, b: int = 1, gamma: int = 2):
        super().__init__()
        ks = int(abs((math.log(channel, 2) + b) / gamma))
        ks = ks if ks % 2 else ks + 1
        c = channel
        self.spatial_conv = nn.Conv1d(c, c, ks, padding=ks - 1, dilation=2, groups=c, bias=False)
        self.gn = nn.GroupNorm(max(1, c // 16), c, eps=1e-5)
        self.ch_att = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(2), nn.Conv1d(c, c, ks, padding=(ks - 1) // 2, groups=c, bias=False)
        )
        self.ch_weight = nn.Parameter(torch.zeros(1))
        self.sp_weight = nn.Parameter(torch.zeros(1))
        self.res_weight = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ch = torch.sigmoid(self.ch_att(x))[..., None]  # (B, C, 1, 1)
        h_att = torch.sigmoid(self.gn(self.spatial_conv(x.mean(3))))[..., None]  # (B, C, H, 1)
        w_att = torch.sigmoid(self.gn(self.spatial_conv(x.mean(2))))[:, :, None, :]  # (B, C, 1, W)
        att = torch.sigmoid(self.ch_weight) * ch + torch.sigmoid(self.sp_weight) * (h_att * w_att)
        return x * att + torch.sigmoid(self.res_weight) * x


class Concat(nn.Module):
    def __init__(self, dim: int = 1):
        super().__init__()
        self.d = dim

    def forward(self, xs) -> torch.Tensor:
        return torch.cat(xs, self.d)


def dfl_decode(dist_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution-focal-loss integral: (..., 4 * reg_max) side-major logits ->
    (..., 4) expected distances, a softmax per side."""
    probs = dist_logits.float().unflatten(-1, (4, reg_max)).softmax(-1)
    return probs @ torch.arange(reg_max, dtype=torch.float32, device=dist_logits.device)
