"""``.ckpt`` checkpoints in the JAX package's format, without msgpack or flax installed.

A file is an 8-byte little-endian header length, the JSON meta, then a
msgpack payload as ``flax.serialization.to_bytes`` writes it: nested maps of
str keys, numpy arrays as msgpack ext type 1 packing ``(shape, dtype name, C
bytes)``, numpy scalars as ext type 3 in the same packing. The payload holds
``params``, ``ema_params`` and ``batch_stats`` as nested flax trees (the JAX
names and layouts, from ``utils/weights.py jax_paths``), ``step`` and
``ema_updates`` as 0-d int32 arrays and, in a full checkpoint, ``train_state``
with every field of the JAX ``TrainState``. Either package reads the other's
files.

This module packs and unpacks the msgpack subset those files use: maps,
arrays, str, bin, int, float, bool, nil and ext.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# --- msgpack --------------------------------------------------------------------------------------------


def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 128:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                               (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"{v} does not fit msgpack's uint64")
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)), (0xD2, ">i", -(1 << 31)),
                              (0xD3, ">q", -(1 << 63))):
            if v >= lo:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"{v} does not fit msgpack's int64")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...], out: list) -> None:
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _ndarray_blob(a: np.ndarray) -> bytes:
    return packb([list(a.shape), a.dtype.name, np.ascontiguousarray(a).tobytes("C")])


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray) or isinstance(obj, np.generic):
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        data = _ndarray_blob(np.asarray(obj))
        n = len(data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            out.append(bytes([fixed[n], code]))
        else:
            _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
            out.append(struct.pack("b", code))
        out.append(data)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode()
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a checkpoint")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (dicts, lists, str, bytes, int, float, bool, None, numpy arrays
    and scalars as flax's ext types), as ``msgpack.packb(..., use_bin_type=True)`` packs them."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not a flax array")
        shape, dtype, buf = unpackb(data)
        a = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return a if code == _EXT_NDARRAY else a[()]

    def read(self):
        b = self.num("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lens:
            raw = bytes(self.take(self.num(lens[b])))
            return raw if b <= 0xC6 else raw.decode()
        if b in (0xC7, 0xC8, 0xC9):
            n = self.num({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.num("b"), n)
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                0xD2: ">i", 0xD3: ">q"}
        if b in nums:
            return self.num(nums[b])
        if 0xD4 <= b <= 0xD8:
            code = self.num("b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.num(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes) -> Any:
    """The inverse of ``packb``; flax arrays come back as numpy arrays (scalars as numpy scalars)."""
    return _Reader(data).read()


# --- checkpoint files -------------------------------------------------------------------------------


def write_checkpoint(path, payload: Dict, meta: Dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(packb(payload))


def load_checkpoint(path) -> Tuple[Dict, Dict]:
    """(payload, meta) of a ``.ckpt`` written by either package."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        blob = f.read()
    return unpackb(blob), meta


def state_payload(state, paths, full: bool = False) -> Dict:
    """The port's ``TrainState`` -> the JAX package's checkpoint payload (``jax_paths`` of the model
    give the tree names and layouts)."""
    from bsyolo_tpu_torch.utils.weights import jax_tree

    tree = lambda t: None if t is None else jax_tree(t, paths)  # noqa: E731
    payload = {
        "params": tree(state.params),
        "ema_params": tree(state.ema_params),
        "batch_stats": tree(state.batch_stats),
        "step": np.asarray(state.step, np.int32),
        "ema_updates": np.asarray(state.ema_updates, np.int32),
    }
    if full:
        payload["train_state"] = {
            "step": np.asarray(state.step, np.int32),
            "params": payload["params"],
            "batch_stats": payload["batch_stats"],
            "ema_params": payload["ema_params"],
            "ema_updates": np.asarray(state.ema_updates, np.int32),
            "slot0": tree(state.slot0),
            "slot1": tree(state.slot1),
            "acc_grads": tree(state.acc_grads),
            "last_opt_step": np.asarray(state.last_opt_step, np.int32),
            "loss_state": {"updates": np.asarray(int(state.loss_state.updates), np.int32),
                           "iou_mean": np.asarray(float(state.loss_state.iou_mean), np.float32)},
        }
    return payload


def save_checkpoint(path, state, paths, meta: Dict, full: bool = False, extras: Optional[Dict] = None) -> None:
    """Write ``state`` as a ``.ckpt``; ``full``: with the whole train state, to resume from; ``extras``: arrays
    merged into the payload (a YOLO-World graph's ``txt_feats``, as the JAX trainer writes them)."""
    write_checkpoint(path, {**state_payload(state, paths, full), **(extras or {})}, meta)


def train_state_from_payload(train_state: Dict, model):
    """A checkpoint's ``train_state`` map -> the port's ``TrainState`` for ``model`` (its params and
    BatchNorm statistics are loaded into the model)."""
    from bsyolo_tpu_torch.utils.weights import train_state_from_jax

    ts = dict(train_state)
    ts["loss_state"] = SimpleNamespace(**ts["loss_state"])
    return train_state_from_jax(SimpleNamespace(**ts), model)


def load_weights(payload: Dict, model, prefer_ema: bool = True) -> None:
    """Load a payload's EMA weights (or params) and BatchNorm statistics into ``model``, every key matched."""
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    params = payload.get("ema_params") if prefer_ema and payload.get("ema_params") is not None else payload["params"]
    model.load_state_dict(state_dict_from_jax({"params": params, "batch_stats": payload.get("batch_stats") or {}}),
                          strict=True)


def strip_optimizer(path, prefer_ema: bool = True) -> float:
    """Drop the embedded train state and promote the EMA weights to ``params`` (the EMA tree
    itself goes); returns the megabytes saved. A no-op on a file without either."""
    path = Path(path)
    before = path.stat().st_size
    payload, meta = load_checkpoint(path)
    payload.pop("train_state", None)
    if prefer_ema and payload.get("ema_params") is not None:
        payload["params"] = payload["ema_params"]
    payload.pop("ema_params", None)
    meta["stripped"] = True
    write_checkpoint(path, payload, meta)
    return (before - path.stat().st_size) / 1e6
