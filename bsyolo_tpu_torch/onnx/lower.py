"""Lower a ``torch.export`` program to an ONNX opset-13 graph (the port's counterpart of
``bsyolo_tpu/onnx/lower.py``, which lowers a jaxpr).

The program is decomposed to core ATen (``ExportedProgram.run_decompositions()``) and each node is
rewritten into standard ONNX ops by one rule per ATen op (``_RULES``); the weights, buffers and lifted
constants become initializers. All shapes are static, so every Reshape target, Slice bound and Expand
shape is a baked int64 constant read from the node's fake value (``node.meta["val"]``). The port's
operators (``bsyolo::decode_xywh``, ``bsyolo::box_best``, ``bsyolo::int8_matmul``) lower to the ONNX
nodes of their plain versions: each such node's plain version is exported at the node's shapes and
inlined. The exportable NMS's ``while_loop`` lowers to an ONNX ``Loop`` whose body reads the outer
values by name. An op without a rule raises ``UnsupportedOp`` naming it.

Dtypes: the graph is float32 end to end; bfloat16 and float16 values are carried as float32 (ONNX
runtimes' bf16 support is spotty and the numpy runtime has none), as the JAX writer does. The ops
emitted are those the JAX package's numpy runtime (``bsyolo_tpu/onnx/runtime.py``) evaluates, so either
package's runtime reads the other's files.
"""

from __future__ import annotations

import operator
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bsyolo_tpu_torch.onnx import proto
from bsyolo_tpu_torch.onnx.builder import GraphBuilder


class UnsupportedOp(NotImplementedError):
    """An ATen op of the exported program has no ONNX lowering yet."""


_DTYPES = {torch.float32: "float32", torch.bfloat16: "float32", torch.float16: "float32", torch.float64: "float64",
           torch.int64: "int64", torch.int32: "int32", torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
           torch.bool: "bool"}


def onnx_dtype(dtype: torch.dtype) -> str:
    """The ONNX element type a torch dtype is carried as (bfloat16 and float16 as float32)."""
    if dtype not in _DTYPES:
        raise UnsupportedOp(f"dtype {dtype} has no ONNX lowering")
    return _DTYPES[dtype]


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy().copy()


def _val(node):
    return node.meta["val"]


def _shape(node) -> List[int]:
    return [int(d) for d in _val(node).shape]


def _dt(node) -> str:
    return onnx_dtype(_val(node).dtype)


def _axis(dim: int, rank: int) -> int:
    return dim + rank if dim < 0 else dim


class _Lowerer:
    def __init__(self, builder: GraphBuilder):
        self.b = builder
        self.consts: Dict[str, np.ndarray] = {}  # initializer name -> value, for folding

    # --- values ----------------------------------------------------------------
    def const(self, array) -> str:
        array = np.asarray(array)
        name = self.b.const_cached(array)
        self.consts[name] = array
        return name

    def i64(self, values) -> str:
        return self.const(np.asarray(values, dtype=np.int64))

    def scalar(self, value, dtype: str) -> str:
        return self.const(np.asarray(value, dtype=np.dtype(dtype)))

    def node(self, op: str, inputs: Sequence[str], n_outputs: int = 1, **attrs) -> List[str]:
        return self.b.node(op, list(inputs), n_outputs=n_outputs, **attrs)

    def one(self, op: str, *inputs: str, **attrs) -> str:
        return self.node(op, inputs, **attrs)[0]

    def cast(self, name: str, have: str, want: str) -> str:
        if have == want:
            return name
        if name in self.consts:
            return self.const(self.consts[name].astype(np.dtype(want)))
        return self.one("Cast", name, to=proto.TENSOR_DTYPE[want])

    def reshape(self, name: str, shape: Sequence[int]) -> str:
        if name in self.consts:
            return self.const(self.consts[name].reshape(shape))
        return self.one("Reshape", name, self.i64(list(shape)))

    def transpose(self, name: str, perm: Sequence[int]) -> str:
        if list(perm) == list(range(len(perm))):
            return name
        if name in self.consts:
            return self.const(np.transpose(self.consts[name], perm))
        return self.one("Transpose", name, perm=list(perm))

    def operand(self, env, arg, dtype: str) -> str:
        """A node's input as an ONNX value of ``dtype``: a node's value (cast if its type differs) or a
        Python number as a constant."""
        if isinstance(arg, torch.fx.Node):
            return self.cast(env[arg], _dt(arg), dtype)
        return self.scalar(arg, dtype)

    # --- graphs ----------------------------------------------------------------
    def lower_graph(self, gm: torch.fx.GraphModule, inputs: Sequence[str]) -> List[Optional[str]]:
        """Lower ``gm``'s nodes with its placeholders bound to ``inputs``; the output node's values."""
        env: Dict[torch.fx.Node, Any] = {}
        feed = iter(inputs)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(feed)
            elif node.op == "get_attr":
                env[node] = getattr(gm, node.target)
            elif node.op == "call_function":
                env[node] = self.lower_node(gm, node, env)
            elif node.op == "output":
                outs = node.args[0]
                outs = [outs] if isinstance(outs, torch.fx.Node) else outs
                return [env[o] if isinstance(o, torch.fx.Node) else None for o in outs]
        raise ValueError("graph without an output node")

    def lower_node(self, gm, node, env):
        if node.target is operator.getitem:
            return env[node.args[0]][node.args[1]]
        key = str(node.target)
        rule = _RULES.get(key)
        if rule is not None:
            return rule(self, node, env)
        if key.startswith("bsyolo."):
            return _inline_reference(self, node, env)
        name = getattr(node.target, "__name__", key)
        raise UnsupportedOp(f"ATen op '{key}' ({name}) has no ONNX lowering; the port's ONNX writer covers the "
                            "inference op set of the ported graphs (see bsyolo_tpu_torch/onnx/lower.py)")

    def lower_program(self, ep: torch.export.ExportedProgram, user_inputs: Sequence[str]) -> List[str]:
        """Lower an exported program (decomposed here) with its user inputs bound to ``user_inputs``;
        weights, buffers and constants become initializers."""
        from torch.export.graph_signature import InputKind

        ep = ep.run_decompositions()
        feed, users = [], iter(user_inputs)
        for spec in ep.graph_signature.input_specs:
            if spec.kind == InputKind.USER_INPUT:
                feed.append(next(users))
            elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER, InputKind.CONSTANT_TENSOR):
                t = ep.state_dict[spec.target] if spec.target in ep.state_dict else ep.constants[spec.target]
                feed.append(self.const(_np(t)))
            else:
                raise UnsupportedOp(f"exported input of kind {spec.kind} has no ONNX lowering")
        n_user = len(ep.graph_signature.user_outputs)
        outs = self.lower_graph(ep.graph_module, feed)
        return outs[len(outs) - n_user:]


_RULES: Dict[str, Callable] = {}


def _rule(*names):
    def deco(fn):
        for n in names:
            _RULES[n] = fn
        return fn

    return deco


def _inline_reference(lw: _Lowerer, node, env):
    """A ``bsyolo::`` operator: its plain version, exported at this node's input shapes and lowered in place."""
    from bsyolo_tpu_torch.kernels import decode, int8_matmul

    op = str(node.target).split(".")[1]
    args = node.args
    if op in ("decode_xywh", "box_best"):
        feats, strides, nc, reg_max = args
        ref = decode.decode_xywh_reference if op == "decode_xywh" else decode.box_best_reference
        fn = lambda *levels: ref(list(levels), strides, nc, reg_max)
        tensors = list(feats)
    elif op == "int8_matmul":
        x, w, sw, sx, out_dtype = args
        fn = lambda a, b, c, d: int8_matmul.int8_matmul_reference(a, b, c, d, out_dtype)
        tensors = [x, w, sw, sx]
    else:
        raise UnsupportedOp(f"operator '{node.target}' has no ONNX lowering")

    class Plain(torch.nn.Module):
        def forward(self, *xs):
            return fn(*xs)

    examples = tuple(torch.zeros(_shape(t), dtype=_val(t).dtype) for t in tensors)
    ep = torch.export.export(Plain(), examples, strict=False)
    outs = lw.lower_program(ep, [env[t] for t in tensors])
    if op == "box_best":
        return outs
    return outs[0]


# --- elementwise -------------------------------------------------------------------

_UNARY = {"aten.sigmoid.default": "Sigmoid", "aten.exp.default": "Exp", "aten.log.default": "Log",
          "aten.abs.default": "Abs", "aten.neg.default": "Neg", "aten.floor.default": "Floor",
          "aten.round.default": "Round", "aten.relu.default": "Relu", "aten.sin.default": "Sin",
          "aten.cos.default": "Cos", "aten.logical_not.default": "Not"}


@_rule(*_UNARY)
def _unary(lw, node, env):
    dt = _dt(node)
    return lw.one(_UNARY[str(node.target)], lw.operand(env, node.args[0], dt))


@_rule("aten.bitwise_not.default")
def _bitwise_not(lw, node, env):
    if _dt(node) != "bool":
        raise UnsupportedOp("aten.bitwise_not on integers has no ONNX lowering")
    return lw.one("Not", env[node.args[0]])


@_rule("aten.rsqrt.default")
def _rsqrt(lw, node, env):
    return lw.one("Reciprocal", lw.one("Sqrt", lw.operand(env, node.args[0], _dt(node))))


@_rule("aten.gelu.default")
def _gelu(lw, node, env):
    x = lw.operand(env, node.args[0], "float32")
    if node.kwargs.get("approximate", "none") != "none":
        raise UnsupportedOp("aten.gelu with approximate='tanh' has no ONNX lowering")
    inner = lw.one("Erf", lw.one("Mul", x, lw.scalar(1 / np.sqrt(2.0), "float32")))
    return lw.one("Mul", lw.one("Mul", x, lw.scalar(0.5, "float32")), lw.one("Add", inner, lw.scalar(1.0, "float32")))


_BINARY = {"aten.add.Tensor": "Add", "aten.sub.Tensor": "Sub", "aten.mul.Tensor": "Mul", "aten.div.Tensor": "Div",
           "aten.maximum.default": "Max", "aten.minimum.default": "Min", "aten.remainder.Scalar": "Mod",
           "aten.bitwise_and.Tensor": "And", "aten.logical_and.default": "And", "aten.bitwise_or.Tensor": "Or"}


@_rule(*_BINARY)
def _binary(lw, node, env):
    op, dt = _BINARY[str(node.target)], _dt(node)
    a, b = (lw.operand(env, x, dt) for x in node.args[:2])
    alpha = node.kwargs.get("alpha", 1)
    if alpha != 1:
        b = lw.one("Mul", b, lw.scalar(alpha, dt))
    if op in ("And", "Or") and dt != "bool":
        raise UnsupportedOp(f"{node.target} on integers has no ONNX lowering")
    return lw.one(op, a, b)


@_rule("aten.div.Tensor_mode")
def _div_mode(lw, node, env):
    """Division with rounding: integers divide in float64 (exact below 2**53) and cast back, which
    truncates, as ONNX Cast does; ``floor`` takes the floor first."""
    dt = _dt(node)
    mode = node.kwargs.get("rounding_mode")
    work = dt if dt in ("float32", "float64") else "float64"
    q = lw.one("Div", *(lw.operand(env, x, work) for x in node.args[:2]))
    if mode == "floor":
        q = lw.one("Floor", q)
    return lw.cast(q, work, dt)


_COMPARE = {"eq": "Equal", "gt": "Greater", "ge": "GreaterOrEqual", "lt": "Less", "le": "LessOrEqual"}


def _compare(lw, node, env):
    op = str(node.target).split(".")[1]
    vals = [_val(a) if isinstance(a, torch.fx.Node) else a for a in node.args[:2]]
    dt = onnx_dtype(torch.result_type(*vals))
    a, b = (lw.operand(env, x, dt) for x in node.args[:2])
    if op == "ne":
        return lw.one("Not", lw.one("Equal", a, b))
    return lw.one(_COMPARE[op], a, b)


for _op in ("eq", "ne", "gt", "ge", "lt", "le"):
    _RULES[f"aten.{_op}.Tensor"] = _RULES[f"aten.{_op}.Scalar"] = _compare


@_rule("aten.where.self")
def _where(lw, node, env):
    dt = _dt(node)
    cond = lw.operand(env, node.args[0], "bool")
    return lw.one("Where", cond, lw.operand(env, node.args[1], dt), lw.operand(env, node.args[2], dt))


@_rule("aten.clamp.default")
def _clamp(lw, node, env):
    dt = _dt(node)
    x = lw.operand(env, node.args[0], dt)
    lo = node.args[1] if len(node.args) > 1 else node.kwargs.get("min")
    hi = node.args[2] if len(node.args) > 2 else node.kwargs.get("max")
    if lo is not None:
        x = lw.one("Max", x, lw.operand(env, lo, dt))
    if hi is not None:
        x = lw.one("Min", x, lw.operand(env, hi, dt))
    return x


@_rule("aten._to_copy.default", "aten.copy.default")
def _to_copy(lw, node, env):
    if str(node.target) == "aten.copy.default":  # copy(dst, src): src in dst's type and shape
        src, dt = node.args[1], _dt(node)
        out = lw.operand(env, src, dt)
        if _shape(src) != _shape(node):
            out = lw.one("Expand", out, lw.i64(_shape(node)))
        return out
    return lw.operand(env, node.args[0], _dt(node))


@_rule("aten.alias.default", "aten.clone.default")
def _identity(lw, node, env):
    return env[node.args[0]]


@_rule("aten._assert_tensor_metadata.default")
def _assert(lw, node, env):
    return None


# --- shapes --------------------------------------------------------------------------


@_rule("aten.view.default", "aten.unsqueeze.default", "aten.squeeze.dims")
def _reshape(lw, node, env):
    return lw.reshape(env[node.args[0]], _shape(node))


@_rule("aten.permute.default")
def _permute(lw, node, env):
    rank = len(_shape(node))
    return lw.transpose(env[node.args[0]], [_axis(d, rank) for d in node.args[1]])


@_rule("aten.expand.default")
def _expand(lw, node, env):
    src = env[node.args[0]]
    if _shape(node.args[0]) == _shape(node):
        return src
    return lw.one("Expand", src, lw.i64(_shape(node)))


@_rule("aten.cat.default")
def _cat(lw, node, env):
    dt = _dt(node)
    parts = [p for p in node.args[0] if 0 not in _shape(p)]
    rank = len(_shape(node))
    dim = _axis(node.args[1] if len(node.args) > 1 else 0, rank)
    return lw.one("Concat", *(lw.operand(env, p, dt) for p in parts), axis=dim)


@_rule("aten.slice.Tensor")
def _slice(lw, node, env):
    x = node.args[0]
    dims = _shape(x)
    dim = _axis(node.args[1] if len(node.args) > 1 else 0, len(dims))
    start = node.args[2] if len(node.args) > 2 and node.args[2] is not None else 0
    end = node.args[3] if len(node.args) > 3 and node.args[3] is not None else dims[dim]
    step = node.args[4] if len(node.args) > 4 else 1
    start = min(max(start + dims[dim] if start < 0 else start, 0), dims[dim])
    end = min(max(end + dims[dim] if end < 0 else end, 0), dims[dim])
    if (start, end, step) == (0, dims[dim], 1):
        return env[x]
    return lw.one("Slice", env[x], lw.i64([start]), lw.i64([end]), lw.i64([dim]), lw.i64([step]))


@_rule("aten.select.int")
def _select(lw, node, env):
    x = node.args[0]
    dims = _shape(x)
    dim = _axis(node.args[1], len(dims))
    idx = node.args[2] + dims[dim] if node.args[2] < 0 else node.args[2]
    return lw.one("Gather", env[x], lw.const(np.asarray(idx, np.int64)), axis=dim)


@_rule("aten.split_with_sizes.default")
def _split(lw, node, env):
    x = node.args[0]
    dims = _shape(x)
    dim = _axis(node.args[2] if len(node.args) > 2 else 0, len(dims))
    sizes = [int(v.shape[dim]) for v in _val(node)]
    return lw.node("Split", [env[x], lw.i64(sizes)], n_outputs=len(sizes), axis=dim)


@_rule("aten.as_strided.default")
def _as_strided(lw, node, env):
    """A strided view of a contiguous value (the decompositions emit it to restride a result): the
    elements it reads, gathered from the flat value."""
    size, stride = node.args[1], node.args[2]
    offset = node.args[3] if len(node.args) > 3 else 0
    idx = np.full(size, offset, np.int64)
    for d, (n, s) in enumerate(zip(size, stride)):
        shape = [1] * len(size)
        shape[d] = n
        idx = idx + (np.arange(n, dtype=np.int64) * s).reshape(shape)
    flat = lw.reshape(env[node.args[0]], [-1])
    return lw.one("Gather", flat, lw.const(idx), axis=0)


@_rule("aten.unfold.default")
def _unfold(lw, node, env):
    x = node.args[0]
    dims = _shape(x)
    dim, size, step = _axis(node.args[1], len(dims)), node.args[2], node.args[3]
    n = (dims[dim] - size) // step + 1
    idx = (np.arange(n)[:, None] * step + np.arange(size)[None]).astype(np.int64)
    g = lw.one("Gather", env[x], lw.const(idx), axis=dim)  # (..., n, size, ...)
    rank = len(dims) + 1
    perm = [a for a in range(rank) if a != dim + 1] + [dim + 1]
    return lw.transpose(g, perm)


@_rule("aten.constant_pad_nd.default")
def _pad(lw, node, env):
    x = node.args[0]
    rank = len(_shape(x))
    pad = list(node.args[1])
    value = node.args[2] if len(node.args) > 2 else 0
    if any(p < 0 for p in pad):
        raise UnsupportedOp("aten.constant_pad_nd with a negative pad has no ONNX lowering")
    begins, ends = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        begins[rank - 1 - i], ends[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    dt = _dt(node)
    return lw.one("Pad", env[x], lw.i64(begins + ends), lw.scalar(value, dt))


# --- constants ----------------------------------------------------------------------


@_rule("aten.arange.start_step")
def _arange(lw, node, env):
    start, end = node.args[0], node.args[1]
    step = node.args[2] if len(node.args) > 2 else 1
    return lw.const(np.arange(start, end, step).astype(np.dtype(_dt(node))))


@_rule("aten.full.default", "aten.scalar_tensor.default")
def _full(lw, node, env):
    value = node.args[1] if str(node.target) == "aten.full.default" else node.args[0]
    return lw.const(np.full(_shape(node), value, dtype=np.dtype(_dt(node))))


# --- reductions ------------------------------------------------------------------------


def _dims(node, x, pos=1):
    rank = len(_shape(x))
    dims = node.args[pos] if len(node.args) > pos and node.args[pos] is not None else list(range(rank))
    dims = [dims] if isinstance(dims, int) else list(dims)
    return [_axis(d, rank) for d in dims] or list(range(rank))


def _keep(node, pos=2):
    return int(bool(node.args[pos] if len(node.args) > pos else node.kwargs.get("keepdim", False)))


@_rule("aten.mean.dim", "aten.amax.default", "aten.sum.dim_IntList", "aten.prod.dim_int")
def _reduce(lw, node, env):
    key = str(node.target)
    x = node.args[0]
    src = lw.operand(env, x, _dt(node))
    dims, keep = _dims(node, x), _keep(node)
    if key.startswith("aten.sum"):
        return lw.one("ReduceSum", src, lw.i64(dims), keepdims=keep)
    op = {"mean": "ReduceMean", "amax": "ReduceMax", "prod": "ReduceProd"}[key.split(".")[1]]
    return lw.one(op, src, axes=dims, keepdims=keep)


@_rule("aten.any.dim", "aten.any.default")
def _any(lw, node, env):
    x = node.args[0]
    whole = str(node.target) == "aten.any.default"
    dims = list(range(len(_shape(x)))) if whole else _dims(node, x)
    xi = lw.cast(env[x], _dt(x), "int32")
    r = lw.one("ReduceMax", xi, axes=dims, keepdims=0 if whole else _keep(node))
    return lw.cast(r, "int32", "bool")


@_rule("aten.argmax.default")
def _argmax(lw, node, env):
    x = node.args[0]
    dim = node.args[1] if len(node.args) > 1 and node.args[1] is not None else None
    src = env[x]
    if dim is None:
        src, dim = lw.reshape(src, [-1]), 0
    return lw.one("ArgMax", src, axis=_axis(dim, max(len(_shape(x)), 1)), keepdims=_keep(node))


@_rule("aten.linalg_vector_norm.default")
def _norm(lw, node, env):
    x = node.args[0]
    order = node.args[1] if len(node.args) > 1 else 2
    if order != 2:
        raise UnsupportedOp(f"aten.linalg_vector_norm of order {order} has no ONNX lowering")
    src = lw.operand(env, x, "float32")
    dims = _dims(node, x, 2)
    s = lw.one("ReduceSum", lw.one("Mul", src, src), lw.i64(dims), keepdims=_keep(node, 3))
    return lw.one("Sqrt", s)


@_rule("aten._softmax.default", "aten._log_softmax.default")
def _softmax(lw, node, env):
    x = node.args[0]
    dim = _axis(node.args[1], len(_shape(x)))
    rank = len(_shape(x))
    src = lw.operand(env, x, _dt(node))
    if dim != rank - 1:  # opset 13 Softmax normalizes along one axis; move it last and back
        perm = [a for a in range(rank) if a != dim] + [dim]
        inv = list(np.argsort(perm))
        y = lw.transpose(lw.one("Softmax", lw.transpose(src, perm), axis=-1), inv)
    else:
        y = lw.one("Softmax", src, axis=-1)
    return lw.one("Log", y) if "log" in str(node.target) else y


@_rule("aten.sort.stable")
def _sort(lw, node, env):
    x = node.args[0]
    dims = _shape(x)
    dim = _axis(node.kwargs.get("dim", -1), len(dims))
    # TopK over the whole axis: a stable order, ties to the lower index, as torch.sort(stable=True)
    return lw.node("TopK", [env[x], lw.i64([dims[dim]])], n_outputs=2, axis=dim,
                   largest=int(bool(node.kwargs.get("descending", False))), sorted=1)


@_rule("aten.topk.default")
def _topk(lw, node, env):
    x = node.args[0]
    dims = _shape(x)
    dim = _axis(node.args[2] if len(node.args) > 2 else -1, len(dims))
    largest = node.args[3] if len(node.args) > 3 else True
    return lw.node("TopK", [env[x], lw.i64([node.args[1]])], n_outputs=2, axis=dim, largest=int(bool(largest)),
                   sorted=1)


# --- gathers -------------------------------------------------------------------------


@_rule("aten.gather.default")
def _gather(lw, node, env):
    x = node.args[0]
    return lw.one("GatherElements", env[x], env[node.args[2]], axis=_axis(node.args[1], len(_shape(x))))


@_rule("aten.index_select.default")
def _index_select(lw, node, env):
    x = node.args[0]
    return lw.one("Gather", env[x], env[node.args[2]], axis=_axis(node.args[1], len(_shape(x))))


@_rule("aten.index.Tensor")
def _index(lw, node, env):
    x, indices = node.args[0], node.args[1]
    given = [i for i, t in enumerate(indices) if t is not None]
    if len(given) != 1:
        raise UnsupportedOp("aten.index.Tensor with more than one index tensor has no ONNX lowering")
    return lw.one("Gather", env[x], lw.cast(env[indices[given[0]]], _dt(indices[given[0]]), "int64"), axis=given[0])


# --- products, convolutions, pooling, normalization -------------------------------------


@_rule("aten.mm.default", "aten.bmm.default")
def _matmul(lw, node, env):
    dt = _dt(node)
    return lw.one("MatMul", lw.operand(env, node.args[0], dt), lw.operand(env, node.args[1], dt))


@_rule("aten.addmm.default")
def _addmm(lw, node, env):
    dt = _dt(node)
    bias, a, b = (lw.operand(env, x, dt) for x in node.args[:3])
    beta, alpha = node.kwargs.get("beta", 1), node.kwargs.get("alpha", 1)
    if (beta, alpha) != (1, 1):
        raise UnsupportedOp("aten.addmm with beta or alpha other than 1 has no ONNX lowering")
    return lw.one("Add", lw.one("MatMul", a, b), bias)


def _zero_interleave(lw, x: str, shape: List[int], axis: int, d: int):
    """Insert d - 1 zeros between the elements of ``axis`` (a transposed convolution's input dilation)."""
    mid = shape[: axis + 1] + [1] + shape[axis + 1:]
    x = lw.reshape(x, mid)
    pads = [0] * (2 * len(mid))
    pads[len(mid) + axis + 1] = d - 1
    x = lw.one("Pad", x, lw.i64(pads), lw.scalar(0.0, "float32"))
    full = shape[:axis] + [shape[axis] * d] + shape[axis + 1:]
    x = lw.reshape(x, full)
    return lw.one("Slice", x, lw.i64([0]), lw.i64([full[axis] - (d - 1)]), lw.i64([axis])), \
        full[:axis] + [full[axis] - (d - 1)] + full[axis + 1:]


@_rule("aten.convolution.default")
def _conv(lw, node, env):
    x, w, b, stride, padding, dilation, transposed, output_padding, groups = node.args
    xs = lw.operand(env, x, "float32")
    ws = lw.operand(env, w, "float32")
    n_sp = len(stride)
    if transposed:
        if groups != 1 or any(d != 1 for d in dilation) or ws not in lw.consts:
            raise UnsupportedOp("aten.convolution transposed with groups, dilation or a computed weight has no "
                                "ONNX lowering")
        shape = _shape(x)
        for i, s in enumerate(stride):
            if s > 1:
                xs, shape = _zero_interleave(lw, xs, shape, 2 + i, s)
        k = list(lw.consts[ws].shape[2:])
        pads = [k[i] - 1 - padding[i] for i in range(n_sp)]
        ends = [k[i] - 1 - padding[i] + output_padding[i] for i in range(n_sp)]
        ws = lw.const(np.flip(np.swapaxes(lw.consts[ws], 0, 1), axis=tuple(range(2, 2 + n_sp))).copy())
        pads_attr, strides, dil = pads + ends, [1] * n_sp, [1] * n_sp
    else:
        pads_attr, strides, dil = list(padding) + list(padding), list(stride), list(dilation)
    inputs = [xs, ws] + ([lw.operand(env, b, "float32")] if b is not None else [])
    return lw.one("Conv", *inputs, strides=strides, pads=pads_attr, dilations=dil, group=int(groups))


@_rule("aten.max_pool2d_with_indices.default")
def _maxpool(lw, node, env):
    a = list(node.args)
    x, kernel = a[0], list(a[1])
    stride = list(a[2]) if len(a) > 2 and a[2] else kernel
    padding = list(a[3]) if len(a) > 3 else [0, 0]
    dilation = list(a[4]) if len(a) > 4 else [1, 1]
    if len(a) > 5 and a[5]:
        raise UnsupportedOp("aten.max_pool2d with ceil_mode has no ONNX lowering")
    padding = padding * 2 if len(padding) == 1 else padding
    out = lw.one("MaxPool", env[x], kernel_shape=kernel, strides=stride * (2 // len(stride)),
                 pads=padding + padding, dilations=dilation * (2 // len(dilation)))
    return [out, None]


@_rule("aten.avg_pool2d.default")
def _avgpool(lw, node, env):
    a = list(node.args)
    kernel = list(a[1])
    stride = list(a[2]) if len(a) > 2 and a[2] else kernel
    padding = list(a[3]) if len(a) > 3 else [0, 0]
    if (len(a) > 4 and a[4]) or (len(a) > 6 and a[6] is not None):
        raise UnsupportedOp("aten.avg_pool2d with ceil_mode or a divisor has no ONNX lowering")
    include = int(a[5]) if len(a) > 5 else 1
    return lw.one("AveragePool", env[a[0]], kernel_shape=kernel, strides=stride, pads=padding + padding,
                  count_include_pad=include)


@_rule("aten.upsample_nearest2d.vec")
def _upsample(lw, node, env):
    return lw.one("Resize", env[node.args[0]], "", "", lw.i64(_shape(node)), mode="nearest",
                  coordinate_transformation_mode="asymmetric", nearest_mode="floor")


def _channel(lw, name: str, rank: int) -> str:
    """A (C,) value as (1, C, 1, ...) for a broadcast over an NC... tensor."""
    return lw.reshape(name, [1, -1] + [1] * (rank - 2))


@_rule("aten._native_batch_norm_legit_no_training.default")
def _batch_norm(lw, node, env):
    x, w, b, mean, var, _momentum, eps = node.args
    rank = len(_shape(x))
    ops = [lw.operand(env, t, "float32") if t is not None else None for t in (w, b, mean, var)]
    if all(o in lw.consts for o in ops if o is not None):  # folded: x * a + c, as the CPU kernel computes it
        cw, cb, cm, cv = (lw.consts[o] if o is not None else None for o in ops)
        invstd = (1.0 / np.sqrt(cv.astype(np.float32) + np.float32(eps))).astype(np.float32)
        alpha = invstd * (cw if cw is not None else 1.0)
        beta = (cb if cb is not None else 0.0) - cm * alpha
        a, c = lw.const(alpha.astype(np.float32)), lw.const(np.asarray(beta, np.float32))
    else:
        wv, bv, mv, vv = ops
        inv = lw.one("Reciprocal", lw.one("Sqrt", lw.one("Add", vv, lw.scalar(eps, "float32"))))
        a = lw.one("Mul", inv, wv) if wv is not None else inv
        c = lw.one("Sub", bv if bv is not None else lw.scalar(0.0, "float32"), lw.one("Mul", mv, a))
    y = lw.one("Add", lw.one("Mul", lw.operand(env, x, "float32"), _channel(lw, a, rank)), _channel(lw, c, rank))
    return [y, None, None]


@_rule("aten.native_group_norm.default")
def _group_norm(lw, node, env):
    x, w, b, n, c, hw, group, eps = node.args
    shape = _shape(x)
    src = lw.operand(env, x, "float32")
    g = lw.reshape(src, [n, group, -1])
    mean = lw.one("ReduceMean", g, axes=[2], keepdims=1)
    d = lw.one("Sub", g, mean)
    var = lw.one("ReduceMean", lw.one("Mul", d, d), axes=[2], keepdims=1)
    y = lw.one("Div", d, lw.one("Sqrt", lw.one("Add", var, lw.scalar(eps, "float32"))))
    y = lw.reshape(y, shape)
    if w is not None:
        y = lw.one("Mul", y, _channel(lw, lw.operand(env, w, "float32"), len(shape)))
    if b is not None:
        y = lw.one("Add", y, _channel(lw, lw.operand(env, b, "float32"), len(shape)))
    return [y, None, None]


@_rule("aten.native_layer_norm.default")
def _layer_norm(lw, node, env):
    x, normalized, w, b, eps = node.args
    axes = list(range(len(_shape(x)) - len(normalized), len(_shape(x))))
    src = lw.operand(env, x, "float32")
    mean = lw.one("ReduceMean", src, axes=axes, keepdims=1)
    d = lw.one("Sub", src, mean)
    var = lw.one("ReduceMean", lw.one("Mul", d, d), axes=axes, keepdims=1)
    y = lw.one("Div", d, lw.one("Sqrt", lw.one("Add", var, lw.scalar(eps, "float32"))))
    if w is not None:
        y = lw.one("Mul", y, lw.operand(env, w, "float32"))
    if b is not None:
        y = lw.one("Add", y, lw.operand(env, b, "float32"))
    return [y, None, None]


# --- control flow ----------------------------------------------------------------------


@_rule("while_loop")
def _while(lw, node, env):
    """``torch._higher_order_ops.while_loop`` -> ONNX Loop: the condition runs once in the enclosing graph
    for the first test and again at the end of the body; the carried values are Loop's loop-carried
    dependencies and the additional inputs are read from the outer scope by name."""
    cond_gm, body_gm = env[node.args[0]], env[node.args[1]]
    carried, extra = list(node.args[2]), list(node.args[3]) if len(node.args) > 3 else []
    init = [env[c] for c in carried]
    outer = [env[e] for e in extra]
    cond0 = lw.cast(lw.lower_graph(cond_gm, init + outer)[0], "bool", "bool")
    b = lw.b
    iter_name, cond_in = b.fresh("loop_iter"), b.fresh("loop_cond")
    carry_in = [b.fresh("loop_v") for _ in init]
    out_names: List[str] = []

    def build():
        new = lw.lower_graph(body_gm, carry_in + outer)
        cond_next = lw.lower_graph(cond_gm, list(new) + outer)[0]
        for src in [cond_next] + list(new):
            nm = b.fresh("loop_out")
            b.node("Identity", [src], outputs=[nm])
            out_names.append(nm)

    specs = [(_shape(c), _dt(c)) for c in carried]
    sub_inputs = [(iter_name, (), "int64"), (cond_in, (), "bool")] + [(n, s, d) for n, (s, d) in zip(carry_in, specs)]
    body = b.subgraph("while_body", sub_inputs, build, out_names, [((), "bool")] + specs)
    return lw.node("Loop", ["", cond0] + init, n_outputs=len(init), body=body)


# --- entry point ---------------------------------------------------------------------------


def export_onnx(fn_or_program, args, path, input_names: Optional[Sequence[str]] = None,
                output_names: Optional[Sequence[str]] = None, name: str = "bsyolo") -> Path:
    """Write an ONNX opset-13 model of ``fn_or_program`` to ``path``: a ``torch.export.ExportedProgram``
    (``args`` unused), or an ``nn.Module`` or function exported here with the example tensors ``args``.
    Graph inputs and outputs take ``input_names`` and ``output_names`` (as many as the program has).
    Raises ``UnsupportedOp`` when the program uses an op outside the lowered set. Returns the path."""
    if isinstance(fn_or_program, torch.export.ExportedProgram):
        ep = fn_or_program
    else:
        module = fn_or_program if isinstance(fn_or_program, torch.nn.Module) else _Fn(fn_or_program)
        ep = torch.export.export(module, tuple(args), strict=False)
    builder = GraphBuilder(name=name)
    lw = _Lowerer(builder)
    user_in = [s for s in ep.graph_signature.input_specs if s.kind.name == "USER_INPUT"]
    in_names = list(input_names or [])[: len(user_in)]
    while len(in_names) < len(user_in):
        in_names.append(f"input_{len(in_names)}")
    placeholders = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    for spec, nm in zip(user_in, in_names):
        v = _val(placeholders[spec.arg.name])
        builder.add_input(nm, list(v.shape), onnx_dtype(v.dtype))
    outs = lw.lower_program(ep, in_names)
    out_nodes = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
    out_nodes = out_nodes[len(out_nodes) - len(outs):]
    out_names = list(output_names or [])[: len(outs)]
    while len(out_names) < len(outs):
        out_names.append(f"output_{len(out_names)}")
    for src, nm, o in zip(outs, out_names, out_nodes):
        builder.node("Identity", [src], outputs=[nm])
        builder.add_output(nm, _shape(o), _dt(o))
    path = Path(path)
    path.write_bytes(builder.model_bytes(doc="exported by bsyolo_tpu_torch (torch.export -> onnx), opset 13"))
    return path


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)
