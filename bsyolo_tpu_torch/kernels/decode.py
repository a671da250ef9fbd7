"""DFL box decode kernels: the port of the two Pallas decode kernels.

Both compute a softmax expectation per box side; they do not copy the TPU
kernels' single max over all 64 bins, which returns NaN when one side's
logits sit far below another's. Both take the port's flattened head
``(B, no, A)`` (NCHW maps with H*W flattened, levels concatenated), anchors
``(A, 2)`` and strides ``(A, 1)``. On a CUDA tensor they launch the kernel; on
a CPU tensor they run the plain PyTorch version of the same function.

- ``box_best``: ``(B, A, 4)`` xyxy pixel boxes and the ``(B, A)`` max class
  logit, for the fused predict postprocess. Port of ``bsyolo_tpu/kernels/
  decode.py:124 _decode_box_kernel`` (entry ``fused_box_best_pallas``) as
  ``csrc/decode_box.cu``.
- ``decode_xywh``: ``(B, A, 4 + nc)`` xywh pixel boxes and sigmoid class
  scores, for ``nn/heads.decode_detections``. Port of ``bsyolo_tpu/kernels/
  decode.py:34 _decode_kernel`` (entry ``fused_decode_pallas``) as
  ``csrc/decode_xywh.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from bsyolo_tpu_torch.kernels.build import load_library
from bsyolo_tpu_torch.nn.modules import dfl_decode
from bsyolo_tpu_torch.ops.anchors import dist2bbox

REG_MAX = 16
# decode_xywh.cu stages 128 output rows of (4 + nc) | 1 floats in shared memory, at most 227 KB a block
DECODE_XYWH_MAX_NC = 449


def box_best_reference(flat: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor, nc: int,
                       reg_max: int = REG_MAX):
    """Plain PyTorch version: dfl_decode + dist2bbox + amax over the class logits."""
    dist = dfl_decode(flat[:, : 4 * reg_max].transpose(1, 2), reg_max)  # (B, A, 4)
    boxes = dist2bbox(dist, anchors[None].float(), xywh=False) * strides.reshape(1, -1, 1).float()
    best = flat[:, 4 * reg_max : 4 * reg_max + nc].float().amax(1)
    return boxes, best


def _check_head(fn: str, flat: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor, nc: int):
    """Raise on what the decode kernels do not take; returns (B, no, A)."""
    if flat.device.type != "cuda":
        raise ValueError(f"{fn} needs a CUDA tensor, got one on {flat.device}")
    if flat.dtype != torch.float32:
        raise TypeError(f"{fn} takes float32 head maps, got {flat.dtype}")
    if flat.dim() != 3 or not flat.is_contiguous():
        raise ValueError(f"{fn} takes a contiguous (B, no, A) tensor, got shape {tuple(flat.shape)}")
    B, no, A = flat.shape
    if no < 4 * REG_MAX + nc:
        raise ValueError(f"head has {no} channels, fewer than 4 * {REG_MAX} + nc = {4 * REG_MAX + nc}")
    for name, t, shape in (("anchors", anchors, (A, 2)), ("strides", strides, (A, 1))):
        if t.device != flat.device or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {flat.device}")
    return B, no, A


def _lib(name: str, entry: str, n_tensors: int) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``entry(tensors..., B, A, no, nc, stream)``
    and ``<name>_error_string`` typed for ctypes."""
    lib = load_library(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_tensors + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def box_best_cuda(flat: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor, nc: int):
    """Launch the CUDA kernel on the current stream; raises on what it does not take."""
    B, no, A = _check_head("box_best_cuda", flat, anchors, strides, nc)
    boxes = torch.empty((B, A, 4), dtype=torch.float32, device=flat.device)
    best = torch.empty((B, A), dtype=torch.float32, device=flat.device)
    lib = _lib("decode_box", "decode_box_best_f32", 5)
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


def decode_xywh_reference(flat: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor, nc: int,
                          reg_max: int = REG_MAX) -> torch.Tensor:
    """Plain PyTorch version: dfl_decode + dist2bbox(xywh=True) * stride + sigmoid of the class logits."""
    dist = dfl_decode(flat[:, : 4 * reg_max].transpose(1, 2), reg_max)  # (B, A, 4)
    dbox = dist2bbox(dist, anchors[None].float(), xywh=True) * strides.reshape(1, -1, 1).float()
    return torch.cat([dbox, torch.sigmoid(flat[:, 4 * reg_max : 4 * reg_max + nc].transpose(1, 2).float())], -1)


def decode_xywh_cuda(flat: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor, nc: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on what it does not take."""
    B, no, A = _check_head("decode_xywh_cuda", flat, anchors, strides, nc)
    if not 0 < nc <= DECODE_XYWH_MAX_NC:
        raise ValueError(f"decode_xywh_cuda takes 1 to {DECODE_XYWH_MAX_NC} classes, got nc={nc}")
    out = torch.empty((B, A, 4 + nc), dtype=torch.float32, device=flat.device)
    lib = _lib("decode_xywh", "decode_xywh_f32", 4)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    with torch.cuda.device(flat.device):
        rc = lib.decode_xywh_f32(
            flat.data_ptr(), anchors.data_ptr(), strides.data_ptr(), out.data_ptr(), B, A, no, nc,
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"decode_xywh launch failed: {lib.decode_xywh_error_string(rc).decode()}")
    decode_xywh_cuda.launches += 1
    return out


decode_xywh_cuda.launches = 0


def decode_xywh(flat: torch.Tensor, anchors: torch.Tensor, strides: torch.Tensor, nc: int) -> torch.Tensor:
    """(B, no, A) head -> (B, A, 4 + nc) xywh pixels + sigmoid class scores."""
    if flat.device.type == "cpu":
        return decode_xywh_reference(flat, anchors, strides, nc)
    return decode_xywh_cuda(flat, anchors, strides, nc)
