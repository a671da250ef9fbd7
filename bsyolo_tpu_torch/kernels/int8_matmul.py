"""Int8 matrix product with per-output-channel dequantization: the port of the
Pallas int8 matmul (``bsyolo_tpu/kernels/int8_matmul.py:38 _kernel``, entry
``int8_matmul``) as ``csrc/int8_matmul.cu``.

    out[m, n] = float(sum_k x_i8[m, k] * w_i8[k, n]) * (sx * sw[n])

with the sum in int32. The signature is the JAX one: ``(M, K)`` int8 times
``(K, N)`` int8, ``sw`` ``(N,)`` float32, ``sx`` a float32 scalar, out float32
or bfloat16. Unlike the Pallas kernel, which needs M % 256 == 0 and N % 128 ==
0, any M, N, K >= 1 is taken. On a CUDA tensor ``int8_matmul`` launches the
kernel; on a CPU tensor it runs the plain PyTorch version of the same function.

The kernel reads both operands with TMA, K contiguous and rows at a pitch that
is a multiple of 16 bytes (``tma_readable``); K itself may be any size. The
int8 conv path hands it such operands: its im2col rows are written at that
pitch (``empty_rows``), and its weight is an ``Int8Weight``, checked, laid out
and described to TMA once. ``int8_matmul_prepared`` takes one.

``int8_matmul`` is the PyTorch operator ``bsyolo::int8_matmul``
(``torch.library.custom_op``, with a fake version of its output's shape and
dtype), which ``torch.export`` records as one node: on CUDA tensors the kernel,
with the weight's ``Int8Weight`` kept on the tensor that owns the weight's
storage (``prepared_weight``), on CPU tensors the plain version. An exported
int8 graph calls it; the eager int8 conv calls ``int8_matmul_prepared``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from bsyolo_tpu_torch.kernels.build import load_library

ROW_ALIGN = 16  # TMA reads rows whose pitch and start are multiples of 16 bytes
TILE_N = (16, 32, 64, 128, 256)  # the kernel's tile widths; N above 256 is tiled by 256
STAGE_K = (32, 64, 128)  # bytes of K per pipeline stage, each the width of a wgmma swizzle
MAX_STAGES = 4
SMEM_LIMIT = 232448  # shared memory one block may use on sm_90 (227 KB)
H100_SMS = 132
_OUT_BYTES = {torch.float32: 4, torch.bfloat16: 2}


class TilePlan(NamedTuple):
    bm: int  # rows of a block's tile: 64 (one consumer warpgroup) or 128 (two)
    bn: int  # columns of a block's tile, one of TILE_N
    kb: int  # bytes of K per stage, one of STAGE_K
    stages: int  # stages of the ring of x tiles
    resident: bool  # the whole weight stays in shared memory (else a weight tile rides in each stage)


def smem_bytes(plan: TilePlan, k: int, out_bytes: int) -> int:
    """Shared memory of one block, as ``Tile::smem_bytes`` in csrc/int8_matmul.cu counts it:
    1024 bytes to align the swizzled tiles, the stages of x rows, the weight's rows (all
    of K where it stays, else a stage's worth per stage), each warpgroup's 64 staged
    output rows of min(bn, 64) + 8 elements, and the barriers."""
    bm, bn, kb, stages, resident = plan
    b_bufs = -(-k // kb) if resident else stages
    return 1024 + (stages * bm + b_bufs * bn) * kb + bm * (min(bn, 64) + 8) * out_bytes + (2 * MAX_STAGES + 1) * 8


@functools.lru_cache(maxsize=4096)
def tile_plan(m: int, n: int, k: int, out_bytes: int = 4, sms: int = H100_SMS) -> TilePlan:
    """The tile of an (m, k) x (k, n) product on a card with ``sms`` SMs:

    - width: the narrowest that holds n (n above 256 in tiles of 256);
    - rows: 128 where that still gives every SM a tile, else 64 (128 x 256 sums need
      too many registers); with 64-row tiles, the width is halved while the tiles
      still fit on the SMs at once (the M = 1,600 products: more, shorter blocks);
    - K per stage: the narrowest of 32, 64 and 128 bytes that holds k;
    - the weight stays in shared memory where it is one tile wide, there are at
      least four tiles per SM (so each block reuses it), and it fits beside two
      stages; otherwise a weight tile rides in each stage;
    - as many stages as fit, up to MAX_STAGES."""
    bn = next((b for b in TILE_N if b >= n), TILE_N[-1])
    bm = 128 if bn < 256 and -(-m // 128) * -(-n // bn) >= sms else 64
    if bm == 64:
        while bn > TILE_N[0] and -(-m // 64) * -(-n // (bn // 2)) <= sms:
            bn //= 2
    kb = next((b for b in STAGE_K if b >= k), STAGE_K[-1])
    tiles = -(-m // bm) * -(-n // bn)
    resident = n <= bn and tiles >= 4 * sms and smem_bytes(TilePlan(bm, bn, kb, 2, True), k, out_bytes) <= SMEM_LIMIT
    free = SMEM_LIMIT - smem_bytes(TilePlan(bm, bn, kb, 0, resident), k, out_bytes)
    stages = free // (bm * kb if resident else (bm + bn) * kb)
    return TilePlan(bm, bn, kb, min(MAX_STAGES, stages), resident)


def tma_readable(t: torch.Tensor) -> bool:
    """Whether the kernel reads the (rows, K) int8 tensor ``t`` in place: K contiguous,
    rows at a pitch that is a multiple of 16 bytes and not below K, the first row
    16-byte aligned."""
    return (t.stride(1) == 1 and t.stride(0) % ROW_ALIGN == 0 and t.stride(0) >= t.shape[1]
            and t.data_ptr() % ROW_ALIGN == 0)


def empty_rows(rows: int, k: int, device) -> torch.Tensor:
    """An uninitialised (rows, k) int8 tensor that ``tma_readable`` accepts: a view of
    rows padded to a multiple of 16 bytes (the kernel never reads the padding)."""
    pitch = -(-k // ROW_ALIGN) * ROW_ALIGN
    return torch.empty((rows, pitch), dtype=torch.int8, device=device)[:, :k]


def pitched(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel reads it in place, else a copy that it does."""
    return t if tma_readable(t) else empty_rows(*t.shape, t.device).copy_(t)


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


_entry = None  # the typed ctypes functions of the library, loaded at first launch


def _lib():
    global _entry
    if _entry is None:
        lib = load_library("int8_matmul")
        lib.int8_matmul_s8.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        lib.int8_matmul_s8.restype = ctypes.c_int
        lib.int8_matmul_weight_map.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                                               + [ctypes.c_int] * 2)
        lib.int8_matmul_weight_map.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        _entry = lib
    return _entry


def _raise(what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"int8_matmul {what} failed: {_lib().int8_matmul_error_string(rc).decode()}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class Int8Weight:
    """The weight operand, checked and laid out once: ``w`` (K, N) int8 codes and
    ``sw`` (N,) float32 scales on one device.

    The kernel reads the weight K-major, as (N, K) rows at a 16-byte pitch. A ``w``
    that is the transpose of such rows (``rows[:, :K].t()``, as the int8 conv
    caches its codes) is read in place; any other is copied here, once. The TMA
    descriptor of each tile width is encoded at its first launch and kept."""

    def __init__(self, w_i8: torch.Tensor, sw: torch.Tensor):
        if w_i8.dtype != torch.int8:
            raise TypeError(f"int8_matmul takes an int8 weight, got {w_i8.dtype}")
        if w_i8.dim() != 2 or min(w_i8.shape) < 1:
            raise ValueError(f"int8_matmul takes a (K, N) weight with K, N >= 1, got {tuple(w_i8.shape)}")
        self.k, self.n = w_i8.shape
        if sw.device != w_i8.device or sw.dtype != torch.float32 or tuple(sw.shape) != (self.n,):
            raise ValueError(f"sw must be a float32 ({self.n},) tensor on {w_i8.device}")
        self.device = w_i8.device
        self.w, self.sw = w_i8, sw.contiguous()
        self.rows = pitched(w_i8.t()) if self.device.type == "cuda" else None  # (N, K), K contiguous
        self._maps = {}  # (K bytes per stage, tile width) -> the 128-byte CUtensorMap of self.rows

    def tensor_map(self, kb: int, bn: int) -> ctypes.Array:
        tmap = self._maps.get((kb, bn))
        if tmap is None:
            tmap = ctypes.create_string_buffer(128)
            _raise("weight descriptor", _lib().int8_matmul_weight_map(tmap, self.rows.data_ptr(), self.n, self.k,
                                                                      self.rows.stride(0), kb, bn))
            self._maps[kb, bn] = tmap
        return tmap


def _launch(x_i8: torch.Tensor, weight: Int8Weight, sx: torch.Tensor, out_dtype: torch.dtype,
            plan: TilePlan = None) -> torch.Tensor:
    """Launch the kernel on the current stream of x's device; checks only what can
    differ from call to call (x, sx, out_dtype). ``plan`` replaces tile_plan's choice,
    to compare plans on the card."""
    dev = x_i8.device
    if dev != weight.device:
        raise ValueError(f"x is on {dev}, the weight on {weight.device}")
    if x_i8.dtype != torch.int8:
        raise TypeError(f"int8_matmul_cuda takes int8 x, got {x_i8.dtype}")
    if x_i8.dim() != 2 or x_i8.shape[1] != weight.k or x_i8.shape[0] < 1:
        raise ValueError(f"int8_matmul_cuda takes x (M >= 1, {weight.k}), got {tuple(x_i8.shape)}")
    out_bytes = _OUT_BYTES.get(out_dtype)
    if out_bytes is None:
        raise TypeError(f"int8_matmul_cuda writes float32 or bfloat16, not {out_dtype}")
    if sx.device != dev or sx.dtype != torch.float32 or sx.dim() != 0:
        raise ValueError(f"sx must be a float32 () tensor on {dev}")
    x = pitched(x_i8)
    m, n, k = x.shape[0], weight.n, weight.k
    bm, bn, kb, stages, resident = plan or tile_plan(m, n, k, out_bytes, _sm_count(dev.index))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    _raise("launch", _lib().int8_matmul_s8(
        x.data_ptr(), x.stride(0), weight.tensor_map(kb, bn), weight.sw.data_ptr(), sx.data_ptr(),
        out.data_ptr(), out_bytes == 2, m, n, k, bm, bn, kb, stages, resident, dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index)))  # the current stream's handle, without a Stream object
    int8_matmul_cuda.launches += 1
    return out


def int8_matmul_cuda(x_i8: torch.Tensor, w_i8: torch.Tensor, sw: torch.Tensor, sx: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on what it does not take.

    Prepares the weight anew on every call (``Int8Weight``); a caller with a fixed
    weight keeps one and calls ``int8_matmul_prepared``. An x that TMA cannot read
    in place (``tma_readable``) is copied first."""
    if x_i8.device.type != "cuda":
        raise ValueError(f"int8_matmul_cuda needs CUDA tensors, got x on {x_i8.device}")
    return _launch(x_i8, Int8Weight(w_i8, sw), sx, out_dtype)


int8_matmul_cuda.launches = 0


def int8_matmul_prepared(x_i8: torch.Tensor, weight: Int8Weight, sx: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``int8_matmul`` with a prepared weight: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if x_i8.device.type == "cpu" and weight.device.type == "cpu":
        return int8_matmul_reference(x_i8, weight.w, weight.sw, sx, out_dtype)
    return _launch(x_i8, weight, sx, out_dtype)


def prepared_weight(w_i8: torch.Tensor, sw: torch.Tensor) -> Int8Weight:
    """The ``Int8Weight`` of (w_i8, sw), kept as an attribute of the tensor that owns w_i8's storage
    (its base: an exported graph's buffer of codes), so that it lives as long as that tensor, and
    made again when w_i8 is another view or either tensor has changed in place. It reads the codes
    through a tensor that shares their storage but is no view of the owner: a view would hold the
    owner from C++, where the garbage collector cannot see the cycle."""
    owner = w_i8 if w_i8._base is None else w_i8._base
    key = (w_i8.data_ptr(), tuple(w_i8.shape), w_i8.stride(), w_i8._version, sw.data_ptr(), sw._version)
    kept = getattr(owner, "_int8_weight", None)
    if kept is None or kept[0] != key:
        codes = w_i8.new_empty(0).set_(w_i8.untyped_storage(), w_i8.storage_offset(), w_i8.shape, w_i8.stride())
        kept = owner._int8_weight = (key, Int8Weight(codes, sw))
    return kept[1]


@torch.library.custom_op("bsyolo::int8_matmul", mutates_args=())
def _int8_matmul_op(x_i8: torch.Tensor, w_i8: torch.Tensor, sw: torch.Tensor, sx: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    if x_i8.device.type == "cpu":
        return int8_matmul_reference(x_i8, w_i8, sw, sx, out_dtype)
    return _launch(x_i8, prepared_weight(w_i8, sw), sx, out_dtype)


@_int8_matmul_op.register_fake
def _(x_i8, w_i8, sw, sx, out_dtype):
    return x_i8.new_empty((x_i8.shape[0], w_i8.shape[1]), dtype=out_dtype)


def int8_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor, sw: torch.Tensor, sx: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) ``out_dtype``, int32 sums dequantized by sx * sw
    (the operator ``bsyolo::int8_matmul``)."""
    return torch.ops.bsyolo.int8_matmul(x_i8, w_i8, sw, sx, out_dtype)
