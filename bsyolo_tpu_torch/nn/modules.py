"""Blocks of the BS-YOLO detection graph (counterpart of ``bsyolo_tpu/nn/modules.py``).

NCHW PyTorch modules that carry the reference torch parameter names, so a
``state_dict`` here lines up key for key with the JAX package's variables
through ``utils/weights.py``. BatchNorm uses eps 1e-3 and momentum 0.03 like
the reference; convolution weights are drawn from torch's default
kaiming-uniform, U(+-1/sqrt(fan_in)), and biases start at zero, as in the JAX
package (``TORCH_INIT``).

Compute dtype (the JAX package's ``dtype=jnp.bfloat16`` graph, ``amp`` and
``half``): every convolution and linear layer is a ``Conv2d``/``Conv1d``/
``ConvTranspose2d``/``Linear`` whose ``compute_dtype`` (None, no cast, unless
``nn.model.set_compute_dtype`` says bfloat16) its input, weight and bias are
cast to, as flax casts them in ``nn.Conv``/``nn.ConvTranspose``/
``nn.Dense(dtype=...)``; parameters stay as they are. The rest follows the
flax graph's dtypes by type promotion: BatchNorm and GroupNorm reduce in
float32 and return their input's dtype, ``Attention`` forms q·k and its
softmax in float32 and casts to v's dtype, and ELA's float32 fusion weights
make its output float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_MOMENTUM = 0.03
BN_EPS = 1e-3
# float32 1/127: the JAX graph's "/ 127.0" runs jitted, and XLA compiles a division by a constant into a
# product with its float32 reciprocal, which differs from the division in the last bit for some inputs
INV_127 = float(torch.tensor(1.0) / 127.0)


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """Same-shape padding."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32 where it is a 2-byte float (the bf16 graph's reductions and attention
    logits run in float32), else as it is (a float64 copy of the graph stays float64)."""
    return t.float() if t.element_size() < 4 else t


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv and linear weight from U(+-1/sqrt(fan_in)) with ``generator``; zero
    their biases; norms start at identity; ELA's fusion weights at zero."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
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


class _CastConv:
    """The convolution (or linear layer) in ``compute_dtype``: input, weight and bias cast to it
    (``.to`` carries the gradient back to a float32 weight). None, the default, casts nothing:
    the float32 graph, or a copy of it made float64 with ``.double()``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, b = self.compute_dtype, self.bias
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), None if b is None else b.to(dt))


class Conv2d(_CastConv, nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype``."""


class Conv1d(_CastConv, nn.Conv1d):
    """``nn.Conv1d`` that computes in ``compute_dtype``."""


class ConvTranspose2d(_CastConv, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``compute_dtype`` (flax ``nn.ConvTranspose(dtype=...)``,
    Proto's 2x upsample); it takes no ``output_size``."""

    def _conv_forward(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(_CastConv, nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (flax ``nn.Dense(dtype=...)``, Classify's last layer)."""

    def _conv_forward(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        return F.linear(x, w, b)


def cast_convs(model: nn.Module):
    """Every convolution and linear layer of ``model`` that takes a compute dtype."""
    return [m for m in model.modules() if isinstance(m, _CastConv)]


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose train mode follows flax ``nn.BatchNorm``, the JAX package's.

    Eval mode is stock. Either mode takes a bfloat16 input with float32 statistics
    and affine parameters, computes in float32 and returns bfloat16, as flax's
    ``nn.BatchNorm(dtype=bfloat16)`` does. In train mode the batch is normalized by its own mean and
    biased variance (stock torch does the same), and the running statistics take
    ``running = 0.97 * running + (1 - 0.97) * batch`` with the batch's *biased*
    variance, E[x^2] - E[x]^2 clipped at 0, as flax computes it. Stock
    ``torch.nn.BatchNorm2d`` puts the unbiased variance (times n / (n - 1)) into
    ``running_var``, which at a 4 x 4 level and batch 2 is 3 % larger per step.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            xf = x.detach().float()
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_(min=0)
            m = 1.0 - BN_MOMENTUM  # flax's momentum, 0.97
            self.running_mean.mul_(m).add_(mean * (1.0 - m))
            self.running_var.mul_(m).add_(var * (1.0 - m))
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class Conv(nn.Module):
    """Conv2d + BatchNorm + SiLU (reference ``Conv``).

    In int8 inference mode (``set_int8_inference``), in eval mode and with
    ``groups == 1``, the convolution runs as the int8 branch of the JAX
    ``_RawConv`` (``bsyolo_tpu/nn/modules.py:150-171``): the input quantized per
    tensor (static scale from calibration, else the batch's abs-max), the
    weight per output channel, int8 x int8 summed in int32 by the int8 matmul
    kernel, dequantized by ``sx * sw`` into the same BN + SiLU tail. The
    kernel's epilogue writes the conv's compute dtype (bfloat16 in the bf16
    graph, as the JAX branch's ``.astype(self.dtype)``).
    """

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None, g: int = 1, d: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU() if act else nn.Identity()
        self.int8 = False  # int8 inference mode, set by set_int8_inference
        self.act_absmax: Optional[float] = None  # static activation abs-max from calibration; None: dynamic
        self._int8_cache = None  # (weight key, Int8Weight of the (K, N) codes and (N,) scales, static sx, 1 / sx)
        self._calib_hook = None  # forward pre-hook on self.conv while calibrating

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8 and not self.training and self.conv.groups == 1:
            return self.act(self.bn(self._int8_conv(x)))
        return self.act(self.bn(self.conv(x)))

    def _int8_codes(self):
        """The weight as an ``Int8Weight`` (codes (Cin * kh * kw, N) and per-channel
        scales (N,), held as (N, K) rows at a 16-byte pitch and checked once), and
        the static activation scale and its float32 reciprocal (None, None when
        dynamic), cached until the weight's version, storage or device changes."""
        from bsyolo_tpu_torch.kernels.int8_matmul import Int8Weight, empty_rows  # here: kernels imports this module

        w = self.conv.weight
        key = (w._version, w.data_ptr(), w.device)
        if self._int8_cache is None or self._int8_cache[0] != key:
            with torch.no_grad():
                wf = w.detach().float()
                sw = wf.abs().amax((1, 2, 3)).clamp_min(1e-12) * INV_127
                wq = torch.round(wf / sw[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
                rows = empty_rows(wq.shape[0], wq[0].numel(), w.device).copy_(wq.reshape(wq.shape[0], -1))
                sx = inv_sx = None
                if self.act_absmax is not None:  # divided in double, then rounded to float32, as JAX's static scale
                    sx = torch.tensor(max(self.act_absmax, 1e-8) / 127.0, dtype=torch.float32, device=w.device)
                    inv_sx = torch.reciprocal(sx)
            self._int8_cache = (key, Int8Weight(rows.t(), sw), sx, inv_sx)
        return self._int8_cache[1:]

    def _int8_conv(self, x: torch.Tensor) -> torch.Tensor:
        from bsyolo_tpu_torch.kernels.int8_matmul import empty_rows, int8_matmul_prepared

        conv = self.conv
        if conv.dilation != (1, 1):
            raise NotImplementedError(f"int8 conv takes no dilation, got {conv}")
        (k, _), (s, _), (p, _) = conv.kernel_size, conv.stride, conv.padding
        weight, sx, inv_sx = self._int8_codes()
        xf = x.float()
        if sx is None:  # dynamic: one abs-max over the whole batch, x / sx
            sx = xf.abs().amax().clamp_min(1e-8) * INV_127
            q = xf / sx
        else:  # static: x times the float32 reciprocal, which is what XLA compiles JAX's x / constant into
            q = xf * inv_sx
        xq = torch.round(q).clamp_(-127, 127).to(torch.int8)
        B, C, H, W = xq.shape
        if k == 1 and s == 1 and p == 0:
            oh, ow = H, W
            src = xq.permute(0, 2, 3, 1)  # (B, H, W, C)
        else:  # im2col: K ordered (cin, kh, kw), as weight.reshape(Cout, -1)
            patches = F.pad(xq, (p, p, p, p)).unfold(2, k, s).unfold(3, k, s)  # (B, C, OH, OW, k, k)
            oh, ow = patches.shape[2:4]
            src = patches.permute(0, 2, 3, 1, 4, 5)  # (B, OH, OW, C, k, k)
        # one copy into rows at a 16-byte pitch, which the kernel reads in place whatever K is
        cols = empty_rows(B * oh * ow, weight.k, xq.device)
        cols.view(src.shape).copy_(src)
        out_dtype = conv.compute_dtype or torch.float32
        y = int8_matmul_prepared(cols, weight, sx, out_dtype)  # (B * OH * OW, Cout), channels last
        return y.view(B, oh, ow, -1).permute(0, 3, 1, 2).contiguous()


def quantizable_convs(model: nn.Module):
    """(name, Conv) of every Conv that int8 mode runs in int8: those with groups == 1."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, Conv) and m.conv.groups == 1]


def scale_key(name: str) -> str:
    """Calibration key of the Conv named ``name``: the name of its ``nn.Conv2d``."""
    return f"{name}.conv" if name else "conv"


def set_int8_inference(model: nn.Module, enabled: bool, scales: Optional[dict] = None) -> None:
    """Turn int8 conv inference on or off for every Conv of ``model``.

    ``scales``: ``{conv name: activation abs-max}`` from ``nn.quant.calibrate_int8``
    (or ``utils.weights.scales_from_jax``) gives static activation scales; a conv
    missing from it, or every conv when it is empty or None, scales dynamically.
    The mode is read at call time; each call drops the cached weight codes.
    """
    for name, m in model.named_modules():
        if isinstance(m, Conv):
            amax = scales.get(scale_key(name)) if scales else None
            m.int8 = bool(enabled)
            m.act_absmax = None if amax is None else float(amax)
            m._int8_cache = None


def int8_inference(model: nn.Module) -> bool:
    """Whether int8 inference is on for ``model``."""
    return any(m.int8 for m in model.modules() if isinstance(m, Conv))


def _record_absmax(conv: nn.Conv2d, args) -> None:
    amax = args[0].detach().float().abs().amax()
    conv.calib_absmax = amax if conv.calib_absmax is None else torch.maximum(conv.calib_absmax, amax)


def set_int8_calibration(model: nn.Module, enabled: bool) -> None:
    """Start or stop recording each quantizable conv's input abs-max.

    Starting turns int8 inference off (calibration runs the float graph) and
    puts a forward pre-hook on every quantizable ``Conv.conv`` that keeps the
    running max of |input| in its ``calib_absmax``; stopping removes the hooks
    and leaves the maxima for ``calibrate_int8`` to read.
    """
    if enabled:
        set_int8_inference(model, False)
    for _, m in quantizable_convs(model):
        if m._calib_hook is not None:
            m._calib_hook.remove()
            m._calib_hook = None
        if enabled:
            m.conv.calib_absmax = None
            m._calib_hook = m.conv.register_forward_pre_hook(_record_absmax)


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
        # q·k and the softmax (B, heads, N, N) in float32 in the bf16 graph (the JAX einsum's
        # preferred_element_type), the weights cast to v's dtype
        attn = ((at_least_f32(q).transpose(-2, -1) @ at_least_f32(k)) * self.scale).softmax(dim=-1).to(v.dtype)
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


def _dw(d: int, k: Tuple[int, int]) -> Conv2d:
    return Conv2d(d, d, k, padding=(k[0] // 2, k[1] // 2), groups=d, bias=True)


class _SE(nn.Module):
    """One branch gate of MSCAAttention: a 1x1 conv on the pooled map (``SEn.conv.0``)."""

    def __init__(self, d: int):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(d, d, 1))

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
        self.dilconv = Conv2d(d, d, 1, groups=d, bias=True)
        self.SE1, self.SE2, self.SE3, self.SE4 = (_SE(d) for _ in range(4))
        self.conv4 = Conv2d(d, d, 1)

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
        self.spatial_conv = Conv1d(c, c, ks, padding=ks - 1, dilation=2, groups=c, bias=False)
        self.gn = nn.GroupNorm(max(1, c // 16), c, eps=1e-5)
        self.ch_att = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(2), Conv1d(c, c, ks, padding=(ks - 1) // 2, groups=c, bias=False)
        )
        self.ch_weight = nn.Parameter(torch.zeros(1))
        self.sp_weight = nn.Parameter(torch.zeros(1))
        self.res_weight = nn.Parameter(torch.zeros(1))

    def _gn(self, t: torch.Tensor) -> torch.Tensor:
        return self.gn(at_least_f32(t)).to(t.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ch = torch.sigmoid(self.ch_att(x))[..., None]  # (B, C, 1, 1)
        h_att = torch.sigmoid(self._gn(self.spatial_conv(x.mean(3))))[..., None]  # (B, C, H, 1)
        w_att = torch.sigmoid(self._gn(self.spatial_conv(x.mean(2))))[:, :, None, :]  # (B, C, 1, W)
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
