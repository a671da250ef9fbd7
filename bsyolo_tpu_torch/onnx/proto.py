"""Protobuf wire-format codec + ONNX message schema (the port's copy of ``bsyolo_tpu/onnx/proto.py``).

No protobuf library: messages are plain dicts and the wire format (varints,
tags, length-delimited fields) is encoded/decoded directly. The schema tables
below are transcribed from the public ``onnx/onnx.proto3`` (ONNX IR spec);
only the fields this framework reads or writes are listed. proto3 parsers
ignore unknown fields, so the subset is forward-compatible.

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
Repeated scalar numerics are emitted packed (proto3 default); the decoder
accepts both packed and unpacked encodings.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

# --- scalar field kinds -------------------------------------------------

INT64 = "int64"  # varint, two's complement for negatives
INT32 = "int32"
ENUM = "enum"
STRING = "string"  # length-delimited utf-8
BYTES = "bytes"
FLOAT = "float"  # 32-bit
DOUBLE = "double"  # 64-bit
MSG = "msg"  # nested message (length-delimited)

# --- ONNX schema ---------------------------------------------------------
# {message: {field_name: (field_number, kind, repeated, [submessage])}}

SCHEMA: Dict[str, Dict[str, tuple]] = {
    "ModelProto": {
        "ir_version": (1, INT64, False),
        "producer_name": (2, STRING, False),
        "producer_version": (3, STRING, False),
        "domain": (4, STRING, False),
        "model_version": (5, INT64, False),
        "doc_string": (6, STRING, False),
        "graph": (7, MSG, False, "GraphProto"),
        "opset_import": (8, MSG, True, "OperatorSetIdProto"),
    },
    "OperatorSetIdProto": {
        "domain": (1, STRING, False),
        "version": (2, INT64, False),
    },
    "GraphProto": {
        "node": (1, MSG, True, "NodeProto"),
        "name": (2, STRING, False),
        "initializer": (5, MSG, True, "TensorProto"),
        "doc_string": (10, STRING, False),
        "input": (11, MSG, True, "ValueInfoProto"),
        "output": (12, MSG, True, "ValueInfoProto"),
        "value_info": (13, MSG, True, "ValueInfoProto"),
    },
    "NodeProto": {
        "input": (1, STRING, True),
        "output": (2, STRING, True),
        "name": (3, STRING, False),
        "op_type": (4, STRING, False),
        "attribute": (5, MSG, True, "AttributeProto"),
        "doc_string": (6, STRING, False),
        "domain": (7, STRING, False),
    },
    "AttributeProto": {
        "name": (1, STRING, False),
        "f": (2, FLOAT, False),
        "i": (3, INT64, False),
        "s": (4, BYTES, False),
        "t": (5, MSG, False, "TensorProto"),
        "g": (6, MSG, False, "GraphProto"),
        "floats": (7, FLOAT, True),
        "ints": (8, INT64, True),
        "strings": (9, BYTES, True),
        "type": (20, ENUM, False),
    },
    "TensorProto": {
        "dims": (1, INT64, True),
        "data_type": (2, INT32, False),
        "float_data": (4, FLOAT, True),
        "int32_data": (5, INT32, True),
        "string_data": (6, BYTES, True),
        "int64_data": (7, INT64, True),
        "name": (8, STRING, False),
        "raw_data": (9, BYTES, False),
        "double_data": (10, DOUBLE, True),
        "uint64_data": (11, INT64, True),
    },
    "ValueInfoProto": {
        "name": (1, STRING, False),
        "type": (2, MSG, False, "TypeProto"),
        "doc_string": (3, STRING, False),
    },
    "TypeProto": {
        "tensor_type": (1, MSG, False, "TypeProto.Tensor"),
    },
    "TypeProto.Tensor": {
        "elem_type": (1, INT32, False),
        "shape": (2, MSG, False, "TensorShapeProto"),
    },
    "TensorShapeProto": {
        "dim": (1, MSG, True, "TensorShapeProto.Dimension"),
    },
    "TensorShapeProto.Dimension": {
        "dim_value": (1, INT64, False),
        "dim_param": (2, STRING, False),
    },
}

# AttributeProto.type enum (onnx.proto3 AttributeProto.AttributeType)
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8

# TensorProto.DataType enum
TENSOR_DTYPE = {
    "float32": 1,
    "uint8": 2,
    "int8": 3,
    "uint16": 4,
    "int16": 5,
    "int32": 6,
    "int64": 7,
    "bool": 9,
    "float16": 10,
    "float64": 11,
    "uint32": 12,
    "uint64": 13,
    "bfloat16": 16,
}
DTYPE_TENSOR = {v: k for k, v in TENSOR_DTYPE.items()}


# --- wire encoding --------------------------------------------------------


def _varint(value: int) -> bytes:
    if value < 0:  # int64 negatives: 10-byte two's complement varint
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field_number: int, wire_type: int) -> bytes:
    return _varint((field_number << 3) | wire_type)


def _encode_scalar(kind: str, value: Any) -> Tuple[int, bytes]:
    """Return (wire_type, payload) for one scalar value."""
    if kind in (INT64, INT32, ENUM):
        return 0, _varint(int(value))
    if kind == FLOAT:
        return 5, struct.pack("<f", float(value))
    if kind == DOUBLE:
        return 1, struct.pack("<d", float(value))
    if kind == STRING:
        payload = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        return 2, payload
    if kind == BYTES:
        return 2, bytes(value)
    raise ValueError(f"unknown scalar kind {kind}")


def encode(message: Dict[str, Any], message_name: str) -> bytes:
    """Encode a dict message against SCHEMA[message_name]."""
    schema = SCHEMA[message_name]
    out = bytearray()
    for field, value in message.items():
        if value is None:
            continue
        spec = schema[field]
        number, kind, repeated = spec[0], spec[1], spec[2]
        if kind == MSG:
            sub = spec[3]
            items = value if repeated else [value]
            for item in items:
                payload = encode(item, sub)
                out += _tag(number, 2) + _varint(len(payload)) + payload
        elif repeated:
            items = list(value)
            if not items:
                continue
            if kind in (INT64, INT32, ENUM, FLOAT, DOUBLE):
                # packed (proto3 default for scalar numerics)
                payload = b"".join(_encode_scalar(kind, v)[1] for v in items)
                out += _tag(number, 2) + _varint(len(payload)) + payload
            else:  # repeated strings/bytes are never packed
                for v in items:
                    wt, payload = _encode_scalar(kind, v)
                    out += _tag(number, wt) + _varint(len(payload)) + payload
        else:
            wt, payload = _encode_scalar(kind, value)
            if wt == 2:
                out += _tag(number, 2) + _varint(len(payload)) + payload
            else:
                out += _tag(number, wt) + payload
    return bytes(out)


# --- wire decoding --------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw_value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        number, wt = key >> 3, key & 7
        if wt == 0:
            value, pos = _read_varint(buf, pos)
        elif wt == 1:
            value = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:
            size, pos = _read_varint(buf, pos)
            value = buf[pos : pos + size]
            pos += size
        elif wt == 5:
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield number, wt, value


def _decode_scalar(kind: str, wt: int, raw: Any) -> Any:
    if kind in (INT32, ENUM):
        v = raw & 0xFFFFFFFF if isinstance(raw, int) else raw
        return v - (1 << 32) if isinstance(v, int) and v >= (1 << 31) else v
    if kind == INT64:
        return _signed64(raw)
    if kind == FLOAT:
        return struct.unpack("<f", raw)[0]
    if kind == DOUBLE:
        return struct.unpack("<d", raw)[0]
    if kind == STRING:
        return raw.decode("utf-8", errors="replace")
    if kind == BYTES:
        return bytes(raw)
    raise ValueError(f"unknown scalar kind {kind}")


def _unpack_packed(kind: str, raw: bytes) -> List[Any]:
    out = []
    if kind in (INT64, INT32, ENUM):
        pos = 0
        while pos < len(raw):
            v, pos = _read_varint(raw, pos)
            out.append(_signed64(v) if kind == INT64 else v)
    elif kind == FLOAT:
        out = list(struct.unpack(f"<{len(raw) // 4}f", raw))
    elif kind == DOUBLE:
        out = list(struct.unpack(f"<{len(raw) // 8}d", raw))
    return out


def decode(buf: bytes, message_name: str) -> Dict[str, Any]:
    """Decode a message buffer into a dict against SCHEMA[message_name]."""
    schema = SCHEMA[message_name]
    by_number = {spec[0]: (name, spec) for name, spec in schema.items()}
    out: Dict[str, Any] = {}
    for number, wt, raw in _iter_fields(buf):
        entry = by_number.get(number)
        if entry is None:
            continue  # unknown field: skip (proto3 semantics)
        name, spec = entry
        kind, repeated = spec[1], spec[2]
        if kind == MSG:
            value = decode(raw, spec[3])
        elif repeated and wt == 2 and kind in (INT64, INT32, ENUM, FLOAT, DOUBLE):
            out.setdefault(name, []).extend(_unpack_packed(kind, raw))
            continue
        else:
            value = _decode_scalar(kind, wt, raw)
        if repeated:
            out.setdefault(name, []).append(value)
        else:
            out[name] = value
    return out


# --- numpy <-> TensorProto -------------------------------------------------


def tensor_from_numpy(array: np.ndarray, name: str) -> Dict[str, Any]:
    array = np.asarray(array, order="C")  # not ascontiguousarray, which gives a 0-d array one dimension
    dtype_name = array.dtype.name
    if dtype_name not in TENSOR_DTYPE:
        raise ValueError(f"unsupported tensor dtype {dtype_name}")
    return {
        "name": name,
        "dims": list(array.shape),
        "data_type": TENSOR_DTYPE[dtype_name],
        "raw_data": array.tobytes(),
    }


def tensor_to_numpy(tensor: Dict[str, Any]) -> np.ndarray:
    dtype = np.dtype(DTYPE_TENSOR[tensor["data_type"]])
    dims = tuple(tensor.get("dims", []))
    raw = tensor.get("raw_data")
    if raw is not None:
        return np.frombuffer(raw, dtype=dtype).reshape(dims).copy()
    # typed-array fallbacks (other writers may use these)
    for field in ("float_data", "int32_data", "int64_data", "double_data", "uint64_data"):
        if tensor.get(field):
            return np.asarray(tensor[field], dtype=dtype).reshape(dims)
    return np.zeros(dims, dtype=dtype)
