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
    their biases; norms start at identity; ELA's fusion weights at zero. Then a module with an
    ``init_parameters(generator)`` of its own (RT-DETR's attention and decoder) draws its own."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, ELA):
            with torch.no_grad():
                for p in (m.ch_weight, m.sp_weight, m.res_weight):
                    p.zero_()
    for m in module.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(generator)


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


LN_EPS = 1e-6  # flax nn.LayerNorm's default


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: epsilon 1e-6, the fast variance E[x^2] - E[x]^2 clipped at 0, computed in
    (at least) float32 and returned in the input's dtype."""

    def __init__(self, c: int):
        super().__init__(c, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_f32(x)
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_(min=0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


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
    While ``frozen_stats`` is set (``frozen_batch_stats``: a recomputed forward
    under remat) train mode normalizes by the batch and leaves the statistics as they are.
    """

    frozen_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.frozen_stats:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
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
        self.int8_frozen = False  # codes held as buffers (freeze_int8_codes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8 and not self.training and self.conv.groups == 1:
            return self.act(self.bn(self._int8_conv(x)))
        return self.act(self.bn(self.conv(x)))

    def _int8_codes(self):
        """The weight as an ``Int8Weight`` (codes (Cin * kh * kw, N) and per-channel
        scales (N,), held as (N, K) rows at a 16-byte pitch and checked once), and
        the static activation scale and its float32 reciprocal (None, None when
        dynamic), cached on this conv until the weight's version, storage or device
        changes."""
        from bsyolo_tpu_torch.kernels.int8_matmul import Int8Weight  # here: kernels imports this module

        w = self.conv.weight
        key = (w._version, w.data_ptr(), w.device)
        if self._int8_cache is None or self._int8_cache[0] != key:
            rows, sw, sx, inv_sx = self._int8_tensors(w)
            self._int8_cache = (key, Int8Weight(rows[:, : w[0].numel()].t(), sw), sx, inv_sx)
        return self._int8_cache[1:]

    def _int8_tensors(self, w: torch.Tensor):
        """(padded (N, pitch) int8 rows, (N,) float32 scales, sx, 1 / sx) of the weight ``w``."""
        from bsyolo_tpu_torch.kernels.int8_matmul import empty_rows  # here: kernels imports this module

        with torch.no_grad():
            wf = w.detach().float()
            sw = wf.abs().amax((1, 2, 3)).clamp_min(1e-12) * INV_127
            wq = torch.round(wf / sw[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
            rows = empty_rows(wq.shape[0], wq[0].numel(), w.device)
            rows.copy_(wq.reshape(wq.shape[0], -1))
            sx = inv_sx = None
            if self.act_absmax is not None:  # divided in double, then rounded to float32, as JAX's static scale
                sx = torch.tensor(max(self.act_absmax, 1e-8) / 127.0, dtype=torch.float32, device=w.device)
                inv_sx = torch.reciprocal(sx)
        return rows._base if rows._base is not None else rows, sw, sx, inv_sx

    def _int8_conv(self, x: torch.Tensor) -> torch.Tensor:
        from bsyolo_tpu_torch.kernels.int8_matmul import empty_rows, int8_matmul, int8_matmul_prepared

        conv = self.conv
        if conv.dilation != (1, 1):
            raise NotImplementedError(f"int8 conv takes no dilation, got {conv}")
        (k, _), (s, _), (p, _) = conv.kernel_size, conv.stride, conv.padding
        kk = conv.weight[0].numel()
        if self.int8_frozen:  # a graph to export: its codes are buffers, which go into the operator as tensors
            sx, inv_sx = self.int8_sx, self.int8_inv_sx
        else:
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
        out_dtype = conv.compute_dtype or torch.float32
        if self.int8_frozen:  # one reshape, which the operator pitches if it must: bsyolo::int8_matmul
            cols = src.reshape(B * oh * ow, kk)
            y = int8_matmul(cols, self.int8_rows[:, :kk].t(), self.int8_sw, sx, out_dtype)
        else:  # one copy into rows at a 16-byte pitch, which the kernel reads in place whatever K is
            cols = empty_rows(B * oh * ow, kk, xq.device)
            cols.view(src.shape).copy_(src)
            y = int8_matmul_prepared(cols, weight, sx, out_dtype)
        return y.view(B, oh, ow, -1).permute(0, 3, 1, 2).contiguous()  # y: (B * OH * OW, Cout), channels last

    def freeze_int8_codes(self) -> None:
        """Hold this conv's int8 codes, scales and static activation scale as buffers
        (``int8_rows``, ``int8_sw``, ``int8_sx``, ``int8_inv_sx``), computed once from
        the current weight: what the exporter does to its copy of a graph before
        tracing, so the exported graph carries them as tensors into the operator
        ``bsyolo::int8_matmul`` (the eager conv calls the kernel with its cached
        ``Int8Weight``)."""
        rows, sw, sx, inv_sx = self._int8_tensors(self.conv.weight)
        self.register_buffer("int8_rows", rows, persistent=False)
        self.register_buffer("int8_sw", sw, persistent=False)
        self.register_buffer("int8_sx", sx, persistent=False)
        self.register_buffer("int8_inv_sx", inv_sx, persistent=False)
        self.int8_frozen = True


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


# --- graph-wide activation (a model YAML's ``activation:`` key) ---------------------------------------------

ACTIVATIONS = {
    "silu": nn.SiLU,
    "relu": nn.ReLU,
    "lrelu": lambda: nn.LeakyReLU(0.1),
    "gelu": nn.GELU,
    "hardswish": nn.Hardswish,
    "mish": nn.Mish,
}


def set_activation(model: nn.Module, name: str) -> None:
    """Give every ``Conv`` of ``model`` that has an activation the graph's ``name`` (``ACTIVATIONS``) in
    place of SiLU: the JAX package's ``ConvBN`` applies the graph-wide activation wherever it has one.
    Blocks that apply SiLU or ReLU themselves (RepConv, RepVGGDW, ResNetBlock's output) keep them."""
    if name == "silu":
        return
    for m in model.modules():
        if isinstance(m, Conv) and isinstance(m.act, nn.SiLU):
            m.act = ACTIVATIONS[name]()


# --- blocks of the YOLO v3, v5, v6, v8, v9 and v10 graphs ----------------------------------------------------


class C2(nn.Module):
    """CSP bottleneck with 2 convolutions: half the channels through n bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, 1)
        return self.cv2(torch.cat([self.m(a), b], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling: parallel stride-1 max pools of kernels ``k``."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1)
        self.m = nn.ModuleList(nn.MaxPool2d(x, 1, x // 2) for x in k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [m(y) for m in self.m], 1))


class GhostConv(nn.Module):
    """A k x k conv to half the channels and a cheap 5 x 5 depthwise "ghost" of it, concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """GhostConv, a stride-2 depthwise conv when ``s`` is 2, a linear GhostConv; shortcut, through a
    depthwise and a 1x1 conv when ``s`` is 2."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False),
        )
        self.shortcut = (nn.Sequential(DWConv(c1, c1, k, s, act=False), Conv(c1, c2, 1, 1, act=False)) if s == 2
                         else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + self.shortcut(x)


class C3Ghost(C3):
    """C3 whose inner blocks are GhostBottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, inner=lambda c: GhostBottleneck(c, c))


class RepVGGDW(nn.Module):
    """A 7 x 7 and a 3 x 3 depthwise conv summed, then SiLU (YOLOv10's large-kernel branch)."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = Conv(ed, ed, 7, 1, 3, g=ed, act=False)
        self.conv1 = Conv(ed, ed, 3, 1, 1, g=ed, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """YOLOv10's conditional identity block: depthwise 3x3, 1x1, depthwise 3x3 (or RepVGGDW), 1x1,
    depthwise 3x3; a shortcut where the widths agree."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            Conv(c1, c1, 3, g=c1),
            Conv(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_),
            Conv(2 * c_, c2, 1),
            Conv(c2, c2, 3, g=c2),
        )
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f whose inner blocks are CIBs."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e, inner=lambda c: CIB(c, c, shortcut, e=1.0, lk=lk))


class PSA(nn.Module):
    """One attention block on half the channels (YOLOv10): ``attn`` and a conv FFN, each with a shortcut."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.attn = Attention(self.c, max(1, self.c // 64), 0.5)
        self.ffn = nn.Sequential(Conv(self.c, self.c * 2, 1), Conv(self.c * 2, self.c, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).chunk(2, 1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat([a, b], 1))


class RepConv(nn.Module):
    """A 3 x 3 and a 1 x 1 conv (each with BatchNorm, no activation) summed, then SiLU; the deploy-time
    fusion of the two is a weight transform the graph does not need."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv1 = Conv(c1, c2, 3, 1, 1, act=False)
        self.conv2 = Conv(c1, c2, 1, 1, 0, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv1(x) + self.conv2(x))


class RepBottleneck(nn.Module):
    """Bottleneck whose first conv is a RepConv."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k: Tuple[int, int] = (3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConv(c1, c_)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepCSP(C3):
    """C3 whose inner blocks are RepBottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e,
                         inner=lambda c: RepBottleneck(c, c, shortcut, g, k=(3, 3), e=1.0))


class RepNCSPELAN4(nn.Module):
    """GELAN block of YOLOv9: a 1x1 conv split in two, two RepCSP + 3x3 conv stages chained on the
    second half, all four concatenated into a 1x1 conv."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = nn.Sequential(RepCSP(c3 // 2, c4, n), Conv(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), Conv(c4, c4, 3, 1))
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        y.append(self.cv2(y[-1]))
        y.append(self.cv3(y[-1]))
        return self.cv4(torch.cat(y, 1))


class ELAN1(nn.Module):
    """RepNCSPELAN4 with plain 3x3 convs for stages (YOLOv9t)."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int):
        super().__init__()
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = Conv(c3 // 2, c4, 3, 1)
        self.cv3 = Conv(c4, c4, 3, 1)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        y.append(self.cv2(y[-1]))
        y.append(self.cv3(y[-1]))
        return self.cv4(torch.cat(y, 1))


class AConv(nn.Module):
    """A 2 x 2 stride-1 average pool, then a stride-2 3x3 conv."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv1(F.avg_pool2d(x, 2, 1, 0))


class ADown(nn.Module):
    """A 2 x 2 stride-1 average pool; half the channels through a stride-2 3x3 conv, half through a
    stride-2 3 x 3 max pool and a 1x1 conv; concatenated."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1 // 2, self.c, 3, 2, 1)
        self.cv2 = Conv(c1 // 2, self.c, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = F.avg_pool2d(x, 2, 1, 0).chunk(2, 1)
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], 1)


class SPPELAN(nn.Module):
    """A 1x1 conv, three chained k x k stride-1 max pools, all four concatenated into a 1x1 conv."""

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__()
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = nn.MaxPool2d(k, 1, k // 2)
        self.cv3 = nn.MaxPool2d(k, 1, k // 2)
        self.cv4 = nn.MaxPool2d(k, 1, k // 2)
        self.cv5 = Conv(4 * c3, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for m in (self.cv2, self.cv3, self.cv4):
            y.append(m(y[-1]))
        return self.cv5(torch.cat(y, 1))


class ResNetBlock(nn.Module):
    """ResNet bottleneck: 1x1, 3x3 (stride ``s``), 1x1 to ``e * c2`` without activation, plus the input
    (through a strided 1x1 conv where the shape changes), then ReLU."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: int = 4):
        super().__init__()
        c3 = e * c2
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, 3, s, 1)
        self.cv3 = Conv(c2, c3, 1, act=False)
        self.shortcut = nn.Sequential(Conv(c1, c3, 1, s, act=False)) if s != 1 or c1 != c3 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.cv3(self.cv2(self.cv1(x))) + self.shortcut(x))


class ResNetLayer(nn.Module):
    """A ResNet stage of ``n`` blocks, or with ``is_first`` the stem: a stride-2 7x7 conv and a stride-2
    3 x 3 max pool."""

    def __init__(self, c1: int, c2: int, s: int = 1, is_first: bool = False, n: int = 1, e: int = 4):
        super().__init__()
        if is_first:
            self.layer = nn.Sequential(Conv(c1, c2, 7, 2, 3), nn.MaxPool2d(3, 2, 1))
        else:
            blocks = [ResNetBlock(c1, c2, s, e)] + [ResNetBlock(e * c2, c2, 1, e) for _ in range(n - 1)]
            self.layer = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class CBLinear(nn.Module):
    """One conv with a bias whose channels split into the taps ``c2s`` (YOLOv9e's second backbone reads
    them through CBFuse); the output is the tuple of taps."""

    def __init__(self, c1: int, c2s: Tuple[int, ...], k: int = 1, s: int = 1):
        super().__init__()
        self.c2s = tuple(c2s)
        self.conv = Conv2d(c1, sum(self.c2s), k, s, autopad(k), bias=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(self.conv(x).split(self.c2s, 1))


class CBFuse(nn.Module):
    """Sum, onto the last input, tap ``idx[i]`` of each CBLinear input ``i``, nearest-resized to it with
    half-pixel centres (``jax.image.resize``'s "nearest", PyTorch's "nearest-exact")."""

    def __init__(self, idx: Tuple[int, ...]):
        super().__init__()
        self.idx = tuple(idx)

    def forward(self, xs) -> torch.Tensor:
        total = xs[-1]
        size = total.shape[2:]
        for i, x in enumerate(xs[:-1]):
            t = x[self.idx[i]]
            if t.shape[2:] != size:
                t = F.interpolate(t.float(), size=tuple(size), mode="nearest-exact").to(t.dtype)
            total = total + t
        return total


class SpaceToDepth(nn.Module):
    """Lossless (B, C, H, W) -> (B, b * b * C, H / b, W / b): output channel ``(dy * b + dx) * C + c``, the
    JAX package's channels-last order (its ``-tpu`` stem), not ``pixel_unshuffle``'s."""

    def __init__(self, block: int = 2):
        super().__init__()
        self.b = block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        b = self.b
        x = x.reshape(B, C, H // b, b, W // b, b).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(B, b * b * C, H // b, W // b)


# --- blocks of the RT-DETR graphs (HGNetv2 backbone, RepC3 neck) --------------------------------------------


class LightConv(nn.Module):
    """A 1x1 conv and a k x k depthwise conv, each with BatchNorm; ReLU after the depthwise one only."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = Conv(c2, c2, k, g=c2, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(self.conv1(x)))


class HGStem(nn.Module):
    """PPHGNetV2's stem, 4x down: a stride-2 3x3 conv, then a branch of two 2x2 convs beside a stride-1 2 x 2
    max pool, each on the map padded by one row and column at the bottom and right (so the pool's ceil and
    floor shapes agree), concatenated into a stride-2 3x3 conv and a 1x1 conv; ReLU after every conv."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = Conv(c1, cm, 3, 2, act=False)
        self.stem2a = Conv(cm, cm // 2, 2, 1, 0, act=False)
        self.stem2b = Conv(cm // 2, cm, 2, 1, 0, act=False)
        self.stem3 = Conv(cm * 2, cm, 3, 2, act=False)
        self.stem4 = Conv(cm, c2, 1, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(F.relu(self.stem1(x)), (0, 1, 0, 1))
        x2 = F.pad(F.relu(self.stem2a(x)), (0, 1, 0, 1))
        x2 = F.relu(self.stem2b(x2))
        x = torch.cat([F.max_pool2d(x, 2, 1), x2], 1)
        return F.relu(self.stem4(F.relu(self.stem3(x))))


class HGBlock(nn.Module):
    """PPHGNetV2's block: ``n`` chained k x k convs (LightConvs with ``lightconv``), each followed by ReLU, all
    their outputs and the input concatenated into a squeeze and an excite 1x1 conv (ReLU); plus the input with
    ``shortcut`` where the widths agree."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6, lightconv: bool = False,
                 shortcut: bool = False):
        super().__init__()
        self.light = lightconv
        self.m = nn.ModuleList(LightConv(c1 if i == 0 else cm, cm, k) if lightconv else
                               Conv(c1 if i == 0 else cm, cm, k, act=False) for i in range(n))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, act=False)
        self.ec = Conv(c2 // 2, c2, 1, act=False)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [x]
        for m in self.m:
            ys.append(m(ys[-1]) if self.light else F.relu(m(ys[-1])))
        y = F.relu(self.ec(F.relu(self.sc(torch.cat(ys, 1)))))
        return y + x if self.add else y


class RepC3(nn.Module):
    """CSP block of the RT-DETR neck: two 1x1 convs, ``n`` RepConvs on the first, the two summed (a 1x1 conv to
    ``c2`` where ``e`` narrows them)."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(RepConv(c_, c_) for _ in range(n)))
        self.cv3 = Conv(c_, c2, 1, 1) if c_ != c2 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.m(self.cv1(x)) + self.cv2(x))


# --- blocks of the YOLO-World graphs (text-guided attention and the contrastive heads) ------------------------


class Index(nn.Module):
    """The last of its inputs, unchanged (the JAX graph's ``Index`` layer)."""

    def forward(self, xs):
        return xs[-1] if isinstance(xs, (list, tuple)) else xs


def _unit_rows(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` over its L2 norm along ``dim`` (the norm in at least float32, plus 1e-12), in at least float32."""
    return t / (torch.linalg.vector_norm(at_least_f32(t), dim=dim, keepdim=True) + 1e-12)


class MaxSigmoidAttnBlock(nn.Module):
    """Text-guided max-sigmoid attention: each of ``nh`` heads scales a 3x3 projection of the map by the sigmoid
    of the largest dot product between the pixel's embedding and any text row (over sqrt(c2 / nh), plus a bias
    per head). The dot products are float32 and the gate returns to the map's dtype, as in the JAX block."""

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512):
        super().__init__()
        self.nh, self.hc = nh, c2 // nh
        self.ec = Conv(c1, ec, 1, act=False) if c1 != ec else None
        self.gl = Linear(gc, ec)
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj_conv = Conv(c1, c2, 3, 1, act=False)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        embed = self.ec(x) if self.ec is not None else x
        g = self.gl(guide)  # (B, K, ec)
        ec = g.shape[-1]
        g = g.reshape(B, -1, self.nh, ec // self.nh)
        e = embed.reshape(B, self.nh, ec // self.nh, H, W)
        aw = torch.einsum("bmchw,bnmc->bmhwn", at_least_f32(e), at_least_f32(g)).amax(-1) / (self.hc ** 0.5)
        aw = torch.sigmoid(aw + self.bias[None, :, None, None]).to(x.dtype)  # (B, nh, H, W)
        y = self.proj_conv(x)
        return (y.view(B, self.nh, self.hc, H, W) * aw[:, :, None]).view(B, -1, H, W)


class C2fAttn(nn.Module):
    """C2f whose bottleneck outputs are followed by a ``MaxSigmoidAttnBlock`` on the last of them, guided by
    the text; everything concatenated into a 1x1 conv."""

    def __init__(self, c1: int, c2: int, n: int = 1, ec: int = 128, nh: int = 1, gc: int = 512,
                 shortcut: bool = False):
        super().__init__()
        self.c = int(c2 * 0.5)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((3 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, k=(3, 3), e=1.0) for _ in range(n))
        self.attn = MaxSigmoidAttnBlock(self.c, self.c, nh, ec, gc)

    def forward(self, x: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        ys.append(self.attn(ys[-1], guide))
        return self.cv2(torch.cat(ys, 1))


class ImagePoolingAttn(nn.Module):
    """The text attends over the image: each level projected to ``ec`` channels (a 1x1 conv with a bias) and
    max-pooled to k x k tokens; queries from the text, keys and values from the tokens, each a LayerNorm and a
    linear layer; ``nh`` heads whose logits and softmax are float32; projected back to the text's width and
    added to the text. Returns the new text (B, K, ct)."""

    def __init__(self, ec: int = 256, ch: Tuple[int, ...] = (), ct: int = 512, nh: int = 8, k: int = 3):
        super().__init__()
        self.ec, self.nh, self.k = ec, nh, k
        self.query = nn.Sequential(LayerNorm(ct), Linear(ct, ec))
        self.key = nn.Sequential(LayerNorm(ec), Linear(ec, ec))
        self.value = nn.Sequential(LayerNorm(ec), Linear(ec, ec))
        self.proj = Linear(ec, ct)
        self.projections = nn.ModuleList(Conv2d(c, ec, 1, bias=True) for c in ch)

    def forward(self, feats, text: torch.Tensor) -> torch.Tensor:
        B, hc = feats[0].shape[0], self.ec // self.nh
        # F.adaptive_max_pool2d's region i spans [floor(i H / k), ceil((i + 1) H / k)), as the JAX package's
        tokens = torch.cat([F.adaptive_max_pool2d(p(f), self.k).flatten(2).transpose(1, 2)
                            for p, f in zip(self.projections, feats)], 1)  # (B, levels * k * k, ec)
        q = self.query(text).view(B, -1, self.nh, hc)
        k = self.key(tokens).view(B, -1, self.nh, hc)
        v = self.value(tokens).view(B, -1, self.nh, hc)
        aw = torch.einsum("bnmc,bkmc->bmnk", at_least_f32(q), at_least_f32(k)) / (hc ** 0.5)
        aw = aw.softmax(-1).to(v.dtype)
        out = torch.einsum("bmnk,bkmc->bnmc", aw, v).reshape(B, -1, self.ec)
        return self.proj(out) + text


class ContrastiveHead(nn.Module):
    """Region-text logits: the cosine of each pixel's embedding with each text row (both L2-normalized in float32)
    times exp(``logit_scale``), plus ``bias``; (B, E, H, W) and (B, K, E) -> (B, K, H, W) float32."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.full((1,), -10.0))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        sim = torch.einsum("bchw,bkc->bkhw", _unit_rows(x, 1), _unit_rows(w, -1))
        return sim * self.logit_scale.exp() + self.bias


class BNContrastiveHead(nn.Module):
    """``ContrastiveHead`` with BatchNorm on the image side in place of its L2 norm; ``logit_scale`` starts at -1."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.norm = BatchNorm2d(embed_dims, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.bias = nn.Parameter(torch.full((1,), -10.0))
        self.logit_scale = nn.Parameter(torch.tensor(-1.0))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        sim = torch.einsum("bchw,bkc->bkhw", at_least_f32(self.norm(x)), _unit_rows(w, -1))
        return sim * self.logit_scale.exp() + self.bias
