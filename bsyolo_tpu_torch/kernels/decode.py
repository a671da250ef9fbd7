"""DFL box decode kernels: the port of the two Pallas decode kernels.

Both compute a softmax expectation per box side; they do not copy the TPU
kernels' single max over all 64 bins, which returns NaN when one side's
logits sit far below another's. Both take the Detect head's maps as
``Detect.forward`` returns them, a list of up to 4 ``(B, no, H, W)`` levels,
with the level strides and ``nc``. On CUDA maps they launch one kernel,
``csrc/decode.cu``, which reads the levels in place and computes each anchor's
centre and stride from a table of the levels; on CPU maps they run the plain
PyTorch version of the same function (``flatten_levels`` + ``make_anchors`` +
the reference math). The kernel is specialised to 16 DFL bins, so
``reg_max != 16`` takes the plain version on either device, as in the JAX
package. Levels may be float32, bfloat16 or float16, one type for all; the
kernel computes and writes float32, and the plain versions cast to float32
first, as the Pallas kernels do.

- ``box_best``: ``(B, A, 4)`` xyxy pixel boxes, the ``(B, A)`` max class logit
  and the ``(B, A, nc)`` class logits (the kernel writes them contiguous; the
  plain version returns a view of the head), for the fused predict
  postprocess. Port of ``bsyolo_tpu/kernels/decode.py:124 _decode_box_kernel``
  (entry ``fused_box_best_pallas``).
- ``decode_xywh``: ``(B, A, 4 + nc)`` xywh pixel boxes and sigmoid class
  scores, for ``nn/heads.decode_detections``. Port of ``bsyolo_tpu/kernels/
  decode.py:34 _decode_kernel`` (entry ``fused_decode_pallas``).

A launch checks the level table once per distinct shape and element size
(``_layout``, cached) and per call only what can differ between calls of one
shape: each level's device, dtype and contiguity.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from bsyolo_tpu_torch.kernels.build import load_library
from bsyolo_tpu_torch.nn.modules import dfl_decode
from bsyolo_tpu_torch.ops.anchors import dist2bbox, make_anchors

REG_MAX = 16
MAX_LEVELS = 4  # P6 graphs have four
TILES = (32, 16, 8, 4)  # cells of one level per block, the kernel's instantiations (32: a 128-byte line per row)
SMEM_LIMIT = 232448  # shared memory one block may use on sm_90 (227 KB)
H100_SMS = 132
_BOX, _XYWH = 0, 1  # the kernel's epilogues
_NAMES = {_BOX: "box_best_cuda", _XYWH: "decode_xywh_cuda"}
# level element types the kernel takes -> its Dtype code in csrc/decode.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def tile_smem(epilogue: int, tile: int, nc: int, esize: int = 4) -> int:
    """Shared memory of one block in bytes, as csrc/decode.cu lays it out: the tile's
    64 + nc channel rows of ``esize``-byte elements, its staged float32 output rows at
    an odd pitch, two (4, tile) float arrays."""
    width = nc if epilogue == _BOX else 4 + nc
    return esize * tile * (4 * REG_MAX + nc) + 4 * tile * (width | 1) + 2 * 4 * tile * 4


# the most classes a block of the smallest tile holds at float32 levels (at least 8 bytes per class and cell)
MAX_NC = next(nc for nc in range(SMEM_LIMIT // (8 * TILES[-1]), 0, -1)
              if tile_smem(_XYWH, TILES[-1], nc) <= SMEM_LIMIT)


@functools.lru_cache(maxsize=1024)
def tile_anchors(epilogue: int, b: int, hws: Sequence[int], nc: int, sms: int = H100_SMS, esize: int = 4) -> int:
    """Cells per block for ``b`` images of levels of ``hws`` cells: the largest tile
    that fits on an SM and still gives every SM at least two blocks, else the
    smallest (a grid that small is latency-bound whatever the tile). Tiles above
    32 cells measured slower on the H100 at every path shape (PERF.md, Findings)."""
    fits = [t for t in TILES if tile_smem(epilogue, t, nc, esize) <= SMEM_LIMIT]
    for t in fits:
        if b * sum(-(-hw // t) for hw in hws) >= 2 * sms:
            return t
    return fits[-1]


class _LevelTable(ctypes.Structure):
    """The pyramid's shape as the kernel reads it (``LevelTable`` in csrc/decode.cu)."""

    _fields_ = [
        ("hw", ctypes.c_int * MAX_LEVELS),  # H * W
        ("w", ctypes.c_int * MAX_LEVELS),
        ("first", ctypes.c_int * MAX_LEVELS),  # the level's first anchor among an image's A
        ("tile0", ctypes.c_int * MAX_LEVELS),  # the level's first tile among an image's tiles
        ("stride", ctypes.c_float * MAX_LEVELS),
        ("levels", ctypes.c_int),
        ("tiles", ctypes.c_int),  # tiles per image
        ("anchors", ctypes.c_int),  # A
    ]


class Layout(NamedTuple):
    table: _LevelTable
    address: int  # of the table, passed to the kernel's entry
    tile: int  # cells per block
    b: int
    no: int
    a: int


@functools.lru_cache(maxsize=256)
def _layout(epilogue: int, shapes: tuple, strides: tuple, nc: int, sms: int = H100_SMS, esize: int = 4) -> Layout:
    """The level table of one shape of the head with ``esize``-byte elements, checked: 1 to
    4 levels of (B, no, H, W) with one B and one no, a stride each, 1 <= nc <= MAX_NC,
    no >= 64 + nc."""
    fn = _NAMES[epilogue]
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"{fn} takes 1 to {MAX_LEVELS} levels, got {len(shapes)}")
    if len(strides) != len(shapes):
        raise ValueError(f"{fn} got {len(strides)} strides for {len(shapes)} levels")
    if any(len(s) != 4 or min(s) < 1 or s[:2] != shapes[0][:2] for s in shapes):
        raise ValueError(f"{fn} takes (B, no, H, W) levels of one B and one no, got {[tuple(s) for s in shapes]}")
    if not 1 <= nc <= MAX_NC:
        raise ValueError(f"{fn} takes 1 to {MAX_NC} classes, got nc={nc}")
    b, no = shapes[0][:2]
    if no < 4 * REG_MAX + nc:
        raise ValueError(f"head has {no} channels, fewer than 4 * {REG_MAX} + nc = {4 * REG_MAX + nc}")
    hws = tuple(h * w for _, _, h, w in shapes)
    tile = tile_anchors(epilogue, b, hws, nc, sms, esize)
    table = _LevelTable()
    first = tile0 = 0
    for i, ((_, _, _, w), hw, stride) in enumerate(zip(shapes, hws, strides)):
        table.hw[i], table.w[i], table.first[i], table.tile0[i], table.stride[i] = hw, w, first, tile0, float(stride)
        first += hw
        tile0 += -(-hw // tile)
    table.levels, table.tiles, table.anchors = len(shapes), tile0, first
    return Layout(table, ctypes.addressof(table), tile, b, no, first)


_entry = None  # the typed ctypes function of the library, loaded at first launch


def _lib():
    global _entry
    if _entry is None:
        lib = load_library("decode")
        lib.decode_levels.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * MAX_LEVELS
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
        lib.decode_levels.restype = ctypes.c_int
        lib.decode_error_string.argtypes = [ctypes.c_int]
        lib.decode_error_string.restype = ctypes.c_char_p
        _entry = lib
    return _entry


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _refuse(epilogue: int, feats: Sequence[torch.Tensor], index: int) -> None:
    fn = _NAMES[epilogue]
    for f in feats:
        if f.get_device() != index:
            raise ValueError(f"{fn} takes levels on one CUDA device, got {[str(g.device) for g in feats]}")
        if f.dtype not in DTYPES or f.dtype != feats[0].dtype:
            raise TypeError(f"{fn} takes level maps of one dtype, float32, bfloat16 or float16, got "
                            f"{[str(g.dtype) for g in feats]}")
        if not f.is_contiguous():
            raise ValueError(f"{fn} takes contiguous (B, no, H, W) levels, got strides {f.stride()}")


def _launch(epilogue: int, feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int):
    """Launch the kernel on the current stream of the levels' device; returns its outputs
    and raises on what it does not take."""
    if not feats or feats[0].get_device() < 0:
        raise ValueError(f"{_NAMES[epilogue]} needs levels on a CUDA device, got "
                         f"{[str(f.device) for f in feats]}")
    index, dtype = feats[0].get_device(), feats[0].dtype
    for f in feats:
        if f.dtype != dtype or f.get_device() != index or not f.is_contiguous() or dtype not in DTYPES:
            _refuse(epilogue, feats, index)
    lay = _layout(epilogue, tuple(f.shape for f in feats), tuple(strides), nc, _sm_count(index), feats[0].element_size())
    f, b, a = feats[0], lay.b, lay.a  # new_empty: outputs float32 on the levels' device, a cheaper call than torch.empty
    outs = ((f.new_empty((b, a, 4), dtype=torch.float32), f.new_empty((b, a), dtype=torch.float32),
             f.new_empty((b, a, nc), dtype=torch.float32)) if epilogue == _BOX
            else (f.new_empty((b, a, 4 + nc), dtype=torch.float32),))
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    maps = [f.data_ptr() for f in feats] + [None] * (MAX_LEVELS - len(feats))
    lib = _lib()
    rc = lib.decode_levels(epilogue, DTYPES[dtype], lay.address, lay.tile, *maps, lay.b, lay.no, nc, *ptrs, index,
                               torch._C._cuda_getCurrentRawStream(index))  # the current stream, without a Stream object
    if rc != 0:
        raise RuntimeError(f"{_NAMES[epilogue]} launch failed: {lib.decode_error_string(rc).decode()}")
    return outs


def flatten_levels(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-level (B, no, H, W) maps -> (B, no, A), anchors level-major then h * W + w."""
    b, no = feats[0].shape[:2]
    return torch.cat([f.reshape(b, no, -1) for f in feats], 2)


def _flat_head(feats: Sequence[torch.Tensor], strides: Sequence[int]):
    """The plain versions' inputs: the (B, no, A) float32 head, (A, 2) anchors, (A, 1) strides."""
    anchors, stride_t = make_anchors([f.shape[2:] for f in feats], strides, 0.5, device=feats[0].device)
    return flatten_levels(feats).float(), anchors, stride_t


def box_best_reference(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = REG_MAX):
    """Plain PyTorch version on the float32 head: dfl_decode + dist2bbox, the max over the
    class logits and a (B, A, nc) view of them."""
    flat, anchors, stride_t = _flat_head(feats, strides)
    dist = dfl_decode(flat[:, : 4 * reg_max].transpose(1, 2), reg_max)  # (B, A, 4)
    boxes = dist2bbox(dist, anchors[None], xywh=False) * stride_t.reshape(1, -1, 1)
    cls = flat[:, 4 * reg_max : 4 * reg_max + nc].transpose(1, 2)
    return boxes, cls.amax(-1), cls


def box_best_cuda(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int):
    """Launch the CUDA kernel (epilogue kBox) on the current stream; raises on what it does not take."""
    outs = _launch(_BOX, feats, strides, nc)
    box_best_cuda.launches += 1
    return outs


box_best_cuda.launches = 0


def box_best(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = REG_MAX):
    """Per-level (B, no, H, W) maps -> ((B, A, 4) xyxy pixels, (B, A) max class logit,
    (B, A, nc) class logits)."""
    if reg_max != REG_MAX or feats[0].is_cpu:
        return box_best_reference(feats, strides, nc, reg_max)
    return box_best_cuda(feats, strides, nc)


def decode_xywh_reference(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int,
                          reg_max: int = REG_MAX) -> torch.Tensor:
    """Plain PyTorch version on the float32 head: dfl_decode + dist2bbox(xywh=True) * stride + sigmoid
    of the class logits."""
    flat, anchors, stride_t = _flat_head(feats, strides)
    dist = dfl_decode(flat[:, : 4 * reg_max].transpose(1, 2), reg_max)  # (B, A, 4)
    dbox = dist2bbox(dist, anchors[None], xywh=True) * stride_t.reshape(1, -1, 1)
    return torch.cat([dbox, torch.sigmoid(flat[:, 4 * reg_max : 4 * reg_max + nc].transpose(1, 2))], -1)


def decode_xywh_cuda(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int) -> torch.Tensor:
    """Launch the CUDA kernel (epilogue kXywh) on the current stream; raises on what it does not take."""
    (out,) = _launch(_XYWH, feats, strides, nc)
    decode_xywh_cuda.launches += 1
    return out


decode_xywh_cuda.launches = 0


def decode_xywh(feats: Sequence[torch.Tensor], strides: Sequence[int], nc: int, reg_max: int = REG_MAX) -> torch.Tensor:
    """Per-level (B, no, H, W) maps -> (B, A, 4 + nc) xywh pixels + sigmoid class scores."""
    if reg_max != REG_MAX or feats[0].is_cpu:
        return decode_xywh_reference(feats, strides, nc, reg_max)
    return decode_xywh_cuda(feats, strides, nc)
