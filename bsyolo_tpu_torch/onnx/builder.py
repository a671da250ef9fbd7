"""ONNX ModelProto builder over the dict-message codec in proto.py (the port's copy of
``bsyolo_tpu/onnx/builder.py``).

Attribute typing is inferred from the Python value:
int -> INT, float -> FLOAT, str -> STRING, list[int] -> INTS,
list[float] -> FLOATS, np.ndarray -> TENSOR.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from bsyolo_tpu_torch.onnx import proto

OPSET = 13
IR_VERSION = 8  # ONNX IR 8 pairs with opset 13+ (ONNX release table)


def _attribute(name: str, value: Any) -> Dict[str, Any]:
    attr: Dict[str, Any] = {"name": name}
    if isinstance(value, bool):
        attr["i"], attr["type"] = int(value), proto.ATTR_INT
    elif isinstance(value, (int, np.integer)):
        attr["i"], attr["type"] = int(value), proto.ATTR_INT
    elif isinstance(value, (float, np.floating)):
        attr["f"], attr["type"] = float(value), proto.ATTR_FLOAT
    elif isinstance(value, str):
        attr["s"], attr["type"] = value.encode("utf-8"), proto.ATTR_STRING
    elif isinstance(value, bytes):
        attr["s"], attr["type"] = value, proto.ATTR_STRING
    elif isinstance(value, np.ndarray):
        attr["t"] = proto.tensor_from_numpy(value, "")
        attr["type"] = proto.ATTR_TENSOR
    elif isinstance(value, (list, tuple)):
        items = list(value)
        if all(isinstance(v, (int, np.integer)) for v in items):
            attr["ints"], attr["type"] = [int(v) for v in items], proto.ATTR_INTS
        elif all(isinstance(v, (int, float, np.floating, np.integer)) for v in items):
            attr["floats"], attr["type"] = [float(v) for v in items], proto.ATTR_FLOATS
        elif all(isinstance(v, (str, bytes)) for v in items):
            attr["strings"] = [v.encode() if isinstance(v, str) else v for v in items]
            attr["type"] = proto.ATTR_STRINGS
        else:
            raise ValueError(f"mixed attribute list for {name}: {items!r}")
    else:
        raise ValueError(f"unsupported attribute value for {name}: {type(value)}")
    return attr


def _value_info(name: str, shape: Sequence[int], dtype: str) -> Dict[str, Any]:
    return {
        "name": name,
        "type": {
            "tensor_type": {
                "elem_type": proto.TENSOR_DTYPE[dtype],
                "shape": {"dim": [{"dim_value": int(d)} for d in shape]},
            }
        },
    }


class GraphBuilder:
    """Accumulates nodes/initializers and serializes a ModelProto."""

    def __init__(self, name: str = "bsyolo"):
        self.name = name
        self.nodes: List[Dict[str, Any]] = []
        self.initializers: List[Dict[str, Any]] = []
        self.inputs: List[Dict[str, Any]] = []
        self.outputs: List[Dict[str, Any]] = []
        self._counter = 0
        self._const_cache: Dict[Any, str] = {}

    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def add_input(self, name: str, shape: Sequence[int], dtype: str = "float32"):
        self.inputs.append(_value_info(name, shape, dtype))

    def add_output(self, name: str, shape: Sequence[int], dtype: str = "float32"):
        self.outputs.append(_value_info(name, shape, dtype))

    def initializer(self, array: np.ndarray, name: Optional[str] = None) -> str:
        name = name or self.fresh("const")
        self.initializers.append(proto.tensor_from_numpy(np.asarray(array), name))
        return name

    def const_cached(self, array: np.ndarray) -> str:
        """Deduplicate small constants (shape tensors, axes) by value."""
        array = np.asarray(array)
        key = (array.dtype.str, array.shape, array.tobytes()) if array.size <= 64 else None
        if key is not None and key in self._const_cache:
            return self._const_cache[key]
        name = self.initializer(array)
        if key is not None:
            self._const_cache[key] = name
        return name

    def node(
        self,
        op_type: str,
        inputs: Sequence[str],
        n_outputs: int = 1,
        outputs: Optional[Sequence[str]] = None,
        **attrs: Any,
    ) -> List[str]:
        outs = list(outputs) if outputs else [self.fresh(op_type.lower()) for _ in range(n_outputs)]
        attributes = []
        for k, v in attrs.items():
            if v is None:
                continue
            if isinstance(v, dict) and "node" in v:  # pre-built subgraph (Loop/If body)
                attributes.append({"name": k, "g": v, "type": proto.ATTR_GRAPH})
            else:
                attributes.append(_attribute(k, v))
        self.nodes.append(
            {
                "input": list(inputs),
                "output": outs,
                "name": self.fresh(op_type),
                "op_type": op_type,
                "attribute": attributes,
            }
        )
        return outs

    def subgraph(
        self,
        name: str,
        inputs: Sequence[tuple],  # (name, shape, dtype)
        build,  # callable run while node emission is redirected to the subgraph
        output_names: Sequence[str],
        output_specs: Sequence[tuple],  # (shape, dtype)
    ) -> Dict[str, Any]:
        """Build a nested GraphProto (ONNX Loop/If body). Nodes emitted inside
        ``build()`` land in the subgraph; initializers stay in the ROOT graph
        (visible to subgraphs through ONNX outer-scope name resolution), so
        constants referenced by the body need no re-plumbing."""
        outer_nodes = self.nodes
        self.nodes = []
        try:
            build()
            sub_nodes = self.nodes
        finally:
            self.nodes = outer_nodes
        return {
            "node": sub_nodes,
            "name": name,
            "input": [_value_info(n, s, d) for n, s, d in inputs],
            "output": [
                _value_info(n, s, d) for n, (s, d) in zip(output_names, output_specs)
            ],
        }

    def model_bytes(self, doc: str = "") -> bytes:
        graph = {
            "node": self.nodes,
            "name": self.name,
            "initializer": self.initializers,
            "input": self.inputs,
            "output": self.outputs,
            "doc_string": doc,
        }
        model = {
            "ir_version": IR_VERSION,
            "producer_name": "bsyolo_tpu_torch",
            "producer_version": "0.1",
            "opset_import": [{"domain": "", "version": OPSET}],
            "graph": graph,
        }
        return proto.encode(model, "ModelProto")
