"""DFL box decode fused with the per-anchor best class logit.

Port of the Pallas TPU kernel ``bsyolo_tpu/kernels/decode.py:124
_decode_box_kernel`` (entry ``fused_box_best_pallas``) as a CUDA C++ kernel
for Hopper, ``csrc/decode_box.cu``. It computes the function, a softmax
expectation per box side; it does not copy the TPU kernel's single max over
all 64 bins, which returns NaN when one side's logits sit far below another's.

``box_best`` takes the port's flattened head ``(B, no, A)`` (NCHW maps with
H*W flattened, levels concatenated) and returns ``(B, A, 4)`` xyxy pixel
boxes and the ``(B, A)`` max class logit. On a CUDA tensor it launches the
kernel; on a CPU tensor it runs ``box_best_reference``, the plain PyTorch
version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

from bsyolo_tpu_torch.kernels.build import load_library
from bsyolo_tpu_torch.nn.modules import dfl_decode
from bsyolo_tpu_torch.ops.anchors import dist2bbox

REG_MAX = 16


def box_best_reference(flat: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor, nc: int,
                       reg_max: int = REG_MAX):
    """Plain PyTorch version: dfl_decode + dist2bbox + amax over the class logits."""
    dist = dfl_decode(flat[:, : 4 * reg_max].transpose(1, 2), reg_max)  # (B, A, 4)
    boxes = dist2bbox(dist, anchors[None].float(), xywh=False) * strides.reshape(1, -1, 1).float()
    best = flat[:, 4 * reg_max : 4 * reg_max + nc].float().amax(1)
    return boxes, best


def _lib() -> ctypes.CDLL:
    lib = load_library("decode_box")
    if lib.decode_box_best_f32.argtypes is None:
        lib.decode_box_best_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.decode_box_best_f32.restype = ctypes.c_int
        lib.decode_box_error_string.argtypes = [ctypes.c_int]
        lib.decode_box_error_string.restype = ctypes.c_char_p
    return lib


def box_best_cuda(flat: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor, nc: int):
    """Launch the CUDA kernel on the current stream; raises on what it does not take."""
    if flat.device.type != "cuda":
        raise ValueError(f"box_best_cuda needs a CUDA tensor, got one on {flat.device}")
    if flat.dtype != torch.float32:
        raise TypeError(f"box_best_cuda takes float32 head maps, got {flat.dtype}")
    if flat.dim() != 3 or not flat.is_contiguous():
        raise ValueError(f"box_best_cuda takes a contiguous (B, no, A) tensor, got shape {tuple(flat.shape)}")
    B, no, A = flat.shape
    if no < 4 * REG_MAX + nc:
        raise ValueError(f"head has {no} channels, fewer than 4 * {REG_MAX} + nc = {4 * REG_MAX + nc}")
    for name, t, shape in (("anchors", anchors, (A, 2)), ("strides", strides, (A, 1))):
        if t.device != flat.device or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {flat.device}")
    boxes = torch.empty((B, A, 4), dtype=torch.float32, device=flat.device)
    best = torch.empty((B, A), dtype=torch.float32, device=flat.device)
    lib = _lib()
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    with torch.cuda.device(flat.device):
        rc = lib.decode_box_best_f32(
            flat.data_ptr(), anchors.data_ptr(), strides.data_ptr(), boxes.data_ptr(), best.data_ptr(),
            B, A, no, nc, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"decode_box_best launch failed: {lib.decode_box_error_string(rc).decode()}")
    box_best_cuda.launches += 1
    return boxes, best


box_best_cuda.launches = 0


def box_best(flat: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor, nc: int):
    """(B, no, A) head -> ((B, A, 4) xyxy pixels, (B, A) max class logit)."""
    if flat.device.type == "cpu":
        return box_best_reference(flat, anchors, strides, nc)
    return box_best_cuda(flat, anchors, strides, nc)
