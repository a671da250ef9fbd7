"""Int8 matrix product with per-output-channel dequantization: the port of the
Pallas int8 matmul (``bsyolo_tpu/kernels/int8_matmul.py:38 _kernel``, entry
``int8_matmul``) as ``csrc/int8_matmul.cu``.

    out[m, n] = float(sum_k x_i8[m, k] * w_i8[k, n]) * (sx * sw[n])

with the sum in int32. The signature is the JAX one: ``(M, K)`` int8 times
``(K, N)`` int8, ``sw`` ``(N,)`` float32, ``sx`` a float32 scalar, out float32
or bfloat16. Unlike the Pallas kernel, which needs M % 256 == 0 and N % 128 ==
0, any M, N, K >= 1 is taken. On a CUDA tensor ``int8_matmul`` launches the
kernel; on a CPU tensor it runs the plain PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from bsyolo_tpu_torch.kernels.build import load_library

K_ALIGN = 16  # the kernel reads K in 16-byte chunks; the wrapper zero-pads K up to a multiple of this


def quantize_sym(x: torch.Tensor, axis=None, bits: int = 8):
    """Symmetric per-tensor (``axis=None``) or per-axis quantization, as the JAX
    ``quantize_sym``: scale ``max(amax, 1e-8) / qmax`` in float32, codes
    ``round(x / scale)`` (half to even) clipped to ``[-qmax - 1, qmax]``."""
    qmax = 2 ** (bits - 1) - 1
    xf = x.float()
    amax = xf.abs().amax() if axis is None else xf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / torch.tensor(float(qmax), device=x.device)  # a true division on every device
    q = torch.round(xf / scale).clamp_(-qmax - 1, qmax).to(torch.int8)
    return q, scale


def int8_matmul_reference(x_i8: torch.Tensor, w_i8: torch.Tensor, sw: torch.Tensor, sx: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version. The product runs in float64, which is exact here:
    |sum| <= K * 128**2 < 2**53 for any K the graph has, and PyTorch runs it on
    both the CPU and CUDA, where it refuses integer ``mm``. Then the
    dequantization in the Pallas kernel's order, ``float(acc) * (sx * sw)``."""
    acc = x_i8.double() @ w_i8.double()
    return (acc.float() * (sx.float() * sw.float())).to(out_dtype)


def _check(x_i8: torch.Tensor, w_i8: torch.Tensor, sw: torch.Tensor, sx: torch.Tensor, out_dtype: torch.dtype):
    """Raise on what the kernel does not take; returns (M, K, N)."""
    if x_i8.device.type != "cuda":
        raise ValueError(f"int8_matmul_cuda needs CUDA tensors, got x on {x_i8.device}")
    if x_i8.dtype != torch.int8 or w_i8.dtype != torch.int8:
        raise TypeError(f"int8_matmul_cuda takes int8 operands, got {x_i8.dtype} and {w_i8.dtype}")
    if x_i8.dim() != 2 or w_i8.dim() != 2 or x_i8.shape[1] != w_i8.shape[0]:
        raise ValueError(f"int8_matmul_cuda takes (M, K) x (K, N), got {tuple(x_i8.shape)} x {tuple(w_i8.shape)}")
    (M, K), N = x_i8.shape, w_i8.shape[1]
    if min(M, K, N) < 1:
        raise ValueError(f"int8_matmul_cuda needs M, K, N >= 1, got {(M, K, N)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_matmul_cuda writes float32 or bfloat16, not {out_dtype}")
    for name, t, shape in (("sw", sw, (N,)), ("sx", sx, ())):
        if t.device != x_i8.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a float32 {shape} tensor on {x_i8.device}")
    if w_i8.device != x_i8.device:
        raise ValueError(f"w is on {w_i8.device}, x on {x_i8.device}")
    return M, K, N


def _k_major(t: torch.Tensor, k: int, kp: int) -> torch.Tensor:
    """``t`` ((rows, K), K contiguous) as a contiguous, 16-byte aligned (rows, kp) int8
    tensor: the same tensor where it already is one, else a zero-padded copy."""
    if k == kp and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return F.pad(t, (0, kp - k)).contiguous()


def _lib() -> ctypes.CDLL:
    lib = load_library("int8_matmul")
    if lib.int8_matmul_s8.argtypes is None:
        lib.int8_matmul_s8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.int8_matmul_s8.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
    return lib


def int8_matmul_cuda(x_i8: torch.Tensor, w_i8: torch.Tensor, sw: torch.Tensor, sx: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on what it does not take.

    The kernel reads the weight transposed, (N, K) with K contiguous. A ``w_i8``
    that is the transpose of such a tensor (``wt.t()``, as the conv path caches
    it) is read in place; any other layout is copied first. A K that is not a
    multiple of 16 is zero-padded in copies of both operands."""
    M, K, N = _check(x_i8, w_i8, sw, sx, out_dtype)
    kp = -(-K // K_ALIGN) * K_ALIGN
    x = _k_major(x_i8, K, kp)
    wt = _k_major(w_i8.t(), K, kp)
    sw = sw.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x_i8.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x_i8.device).cuda_stream
    with torch.cuda.device(x_i8.device):
        rc = lib.int8_matmul_s8(x.data_ptr(), wt.data_ptr(), sw.data_ptr(), sx.data_ptr(), out.data_ptr(),
                                int(out_dtype == torch.bfloat16), M, N, kp, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: {lib.int8_matmul_error_string(rc).decode()}")
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0


def int8_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor, sw: torch.Tensor, sx: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) ``out_dtype``, int32 sums dequantized by sx * sw."""
    if x_i8.device.type == "cpu":
        return int8_matmul_reference(x_i8, w_i8, sw, sx, out_dtype)
    return int8_matmul_cuda(x_i8, w_i8, sw, sx, out_dtype)
