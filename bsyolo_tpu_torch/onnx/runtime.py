"""Numpy evaluator for ONNX graphs (the port's copy of ``bsyolo_tpu/onnx/runtime.py``; the ``.onnx``
runtime of ``engine/backend.py AutoBackend``).

Independent of the exporter: it parses the protobuf file (via proto.py) and
executes nodes with numpy semantics written against the ONNX operator spec,
so an export parity test is a round trip through the serialized bytes, not a
shared in-memory structure. Covers the op set the lowerer emits (plus
Gemm/AveragePool/Softmax/Flatten for third-party files); static shapes.
It runs on the host: a reference runtime, not a serving path (the port serves
``.pt2`` artifacts on the card).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np

from bsyolo_tpu_torch.onnx import proto


def _attr_map(node: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for a in node.get("attribute", []):
        t = a.get("type")
        if t == proto.ATTR_INT:
            out[a["name"]] = a.get("i", 0)
        elif t == proto.ATTR_FLOAT:
            out[a["name"]] = a.get("f", 0.0)
        elif t == proto.ATTR_STRING:
            out[a["name"]] = a.get("s", b"").decode("utf-8", errors="replace")
        elif t == proto.ATTR_INTS:
            out[a["name"]] = [int(v) for v in a.get("ints", [])]
        elif t == proto.ATTR_FLOATS:
            out[a["name"]] = [float(v) for v in a.get("floats", [])]
        elif t == proto.ATTR_TENSOR:
            out[a["name"]] = proto.tensor_to_numpy(a["t"])
        elif t == proto.ATTR_GRAPH:
            out[a["name"]] = a["g"]
        else:
            out[a["name"]] = a
    return out


def _pool_view(x: np.ndarray, kernel: Sequence[int], strides: Sequence[int], dilations: Sequence[int]):
    """sliding windows over trailing spatial dims of [N, C, *S]."""
    spatial = x.shape[2:]
    eff = [(k - 1) * d + 1 for k, d in zip(kernel, dilations)]
    view = np.lib.stride_tricks.sliding_window_view(x, eff, axis=tuple(range(2, 2 + len(kernel))))
    # view: [N, C, *out_full, *eff]; subsample strides on out dims, dilation in windows
    idx = (slice(None), slice(None))
    idx += tuple(slice(None, None, s) for s in strides)
    idx += tuple(slice(None, None, d) for d in dilations)
    return view[idx]


def _pad_spatial(x: np.ndarray, pads: Sequence[int], value: float) -> np.ndarray:
    n = len(pads) // 2
    width = [(0, 0), (0, 0)] + [(pads[i], pads[n + i]) for i in range(n)]
    if all(w == (0, 0) for w in width):
        return x
    return np.pad(x, width, constant_values=value)


class OnnxModule:
    """Parse an .onnx file and run it: ``OnnxModule(path)(x)``."""

    def __init__(self, path):
        self.model = proto.decode(Path(path).read_bytes(), "ModelProto")
        graph = self.model.get("graph", {})
        self.graph = graph
        self.initializers = {
            t["name"]: proto.tensor_to_numpy(t) for t in graph.get("initializer", [])
        }
        self.input_names = [
            vi["name"] for vi in graph.get("input", []) if vi["name"] not in self.initializers
        ]
        self.output_names = [vi["name"] for vi in graph.get("output", [])]
        self.nodes = graph.get("node", [])
        # liveness: last top-level node index that reads each tensor
        # (including reads from inside Loop body subgraphs, which see the
        # outer scope) — lets __call__ free consumed activations instead of
        # holding every intermediate until the end (a full YOLO graph's
        # activations sum to GBs of host f32)
        def _refs(node):
            names = [n for n in node.get("input", []) if n]
            for a in node.get("attribute", []):
                g = a.get("g")
                if g:
                    for sub in g.get("node", []):
                        names += _refs(sub)
            return names

        self._last_use: Dict[str, int] = {}
        for i, node in enumerate(self.nodes):
            for n in _refs(node):
                self._last_use[n] = i
        self._keep = set(self.output_names) | set(self.initializers)

    @property
    def opset(self) -> int:
        for op in self.model.get("opset_import", []):
            if not op.get("domain"):
                return int(op.get("version", 0))
        return 0

    def __call__(self, *inputs: np.ndarray) -> List[np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.initializers)
        for name, val in zip(self.input_names, inputs):
            env[name] = np.asarray(val)
        self._run_nodes(self.nodes, env, free=True)
        return [env[n] for n in self.output_names]

    def _run_nodes(self, nodes, env: Dict[str, np.ndarray], free: bool = False):
        for i, node in enumerate(nodes):
            op = node["op_type"]
            if op == "Loop":
                self._loop(node, env)
            else:
                fn = _OPS.get(op)
                if fn is None:
                    raise NotImplementedError(f"onnx runtime: op {op} not implemented")
                args = [env[n] if n else None for n in node.get("input", [])]
                outs = fn(_attr_map(node), *args)
                if not isinstance(outs, (list, tuple)):
                    outs = [outs]
                for name, val in zip(node.get("output", []), outs):
                    env[name] = val
            if free:  # top-level liveness: drop tensors past their last reader
                for n in set(node.get("input", [])):
                    if n and n in env and n not in self._keep and self._last_use.get(n, -1) <= i:
                        del env[n]

    def _loop(self, node, env: Dict[str, np.ndarray]):
        """ONNX Loop: body subgraph sees the outer scope (spec: names in
        enclosing graphs are visible); loop-carried deps only, no scan outs."""
        body = None
        for a in node.get("attribute", []):
            if a["name"] == "body":
                body = a["g"]
        if body is None:
            raise ValueError("Loop node without body graph")
        ins = node.get("input", [])
        max_trip = env.get(ins[0]) if ins and ins[0] else None
        cond = env[ins[1]] if len(ins) > 1 and ins[1] else np.asarray(True)
        carries = [env[n] for n in ins[2:]]
        body_in = [vi["name"] for vi in body.get("input", [])]
        body_out = [vi["name"] for vi in body.get("output", [])]
        n_carries = len(carries)
        if len(body_out) != 1 + n_carries:
            raise NotImplementedError("Loop scan outputs not supported")
        sub_inits = {t["name"]: proto.tensor_to_numpy(t) for t in body.get("initializer", [])}
        it = 0
        while bool(np.asarray(cond).reshape(())) and (
            max_trip is None or it < int(np.asarray(max_trip).reshape(()))
        ):
            if it > 1_000_000:
                raise RuntimeError("Loop exceeded 1e6 iterations")
            sub = dict(env)
            sub.update(sub_inits)
            sub[body_in[0]] = np.asarray(it, np.int64)
            sub[body_in[1]] = np.asarray(cond)
            for nm, v in zip(body_in[2:], carries):
                sub[nm] = v
            self._run_nodes(body.get("node", []), sub)
            cond = sub[body_out[0]]
            carries = [sub[n] for n in body_out[1:]]
            it += 1
        for nm, v in zip(node.get("output", []), carries):
            env[nm] = v


# --- operator implementations ------------------------------------------------

_OPS: Dict[str, Any] = {}


def _op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn

    return deco


@_op("Identity")
def _identity(attrs, x):
    return x


_UNARY = {
    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "Exp": np.exp,
    "Log": np.log,
    "Tanh": np.tanh,
    "Sqrt": np.sqrt,
    "Reciprocal": lambda x: 1.0 / x,
    "Abs": np.abs,
    "Neg": np.negative,
    "Sign": np.sign,
    "Floor": np.floor,
    "Ceil": np.ceil,
    "Round": lambda x: np.round(x),  # numpy rounds half-to-even, matching ONNX
    "Not": np.logical_not,
    "Relu": lambda x: np.maximum(x, 0),
    "Sin": np.sin,
    "Cos": np.cos,
    "Atan": np.arctan,
}
for _name, _fn in _UNARY.items():
    _OPS[_name] = (lambda f: lambda attrs, x: f(x).astype(x.dtype) if x.dtype.kind == "f" else f(x))(_fn)
_OPS["Not"] = lambda attrs, x: np.logical_not(x)


@_op("Erf")
def _erf(attrs, x):
    # Abramowitz-Stegun 7.1.26 is not enough for parity; use the exact
    # complementary decomposition via math.erf on the flattened array
    import math

    flat = np.vectorize(math.erf, otypes=[np.float64])(x.astype(np.float64))
    return flat.astype(x.dtype)


@_op("Add")
def _add(attrs, a, b):
    return a + b


@_op("Sub")
def _sub(attrs, a, b):
    return a - b


@_op("Mul")
def _mul(attrs, a, b):
    return a * b


@_op("Div")
def _div(attrs, a, b):
    return a / b


@_op("Pow")
def _pow(attrs, a, b):
    return np.power(a, b).astype(a.dtype)


@_op("Mod")
def _mod(attrs, a, b):
    if attrs.get("fmod"):
        return np.fmod(a, b)
    return np.mod(a, b)


@_op("Max")
def _max(attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = np.maximum(out, x)
    return out


@_op("Min")
def _min(attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = np.minimum(out, x)
    return out


@_op("And")
def _and(attrs, a, b):
    return np.logical_and(a, b)


@_op("Or")
def _or(attrs, a, b):
    return np.logical_or(a, b)


@_op("Xor")
def _xor(attrs, a, b):
    return np.logical_xor(a, b)


@_op("Equal")
def _equal(attrs, a, b):
    return np.equal(a, b)


@_op("Less")
def _less(attrs, a, b):
    return np.less(a, b)


@_op("LessOrEqual")
def _le(attrs, a, b):
    return np.less_equal(a, b)


@_op("Greater")
def _greater(attrs, a, b):
    return np.greater(a, b)


@_op("GreaterOrEqual")
def _ge(attrs, a, b):
    return np.greater_equal(a, b)


@_op("Where")
def _where(attrs, cond, x, y):
    return np.where(cond, x, y)


@_op("Clip")
def _clip(attrs, x, lo=None, hi=None):
    if lo is not None:
        x = np.maximum(x, lo)
    if hi is not None:
        x = np.minimum(x, hi)
    return x


@_op("Cast")
def _cast(attrs, x):
    return x.astype(np.dtype(proto.DTYPE_TENSOR[int(attrs["to"])]))


@_op("Concat")
def _concat(attrs, *xs):
    return np.concatenate(xs, axis=int(attrs["axis"]))


@_op("Reshape")
def _reshape(attrs, x, shape):
    target = [int(s) for s in shape]
    # ONNX: 0 copies the input dim, -1 infers
    target = [x.shape[i] if s == 0 else s for i, s in enumerate(target)]
    return x.reshape(target)


@_op("Transpose")
def _transpose(attrs, x):
    perm = attrs.get("perm") or list(range(x.ndim))[::-1]
    return np.transpose(x, perm)


@_op("Expand")
def _expand(attrs, x, shape):
    return np.broadcast_to(x, np.broadcast_shapes(tuple(int(s) for s in shape), x.shape)).copy()


@_op("Slice")
def _slice(attrs, x, starts, ends, axes=None, steps=None):
    starts = [int(v) for v in starts]
    ends = [int(v) for v in ends]
    axes = [int(v) for v in axes] if axes is not None else list(range(len(starts)))
    steps = [int(v) for v in steps] if steps is not None else [1] * len(starts)
    idx = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        dim = x.shape[ax]
        if sp > 0:
            st0 = min(max(st + dim if st < 0 else st, 0), dim)
            en0 = min(max(en + dim if en < 0 else en, 0), dim)
            idx[ax] = slice(st0, en0, sp)
        else:
            st0 = min(max(st + dim if st < 0 else st, 0), dim - 1)
            if en < -dim:  # ONNX: end below -dim means "through element 0"
                idx[ax] = slice(st0, None, sp)
            else:
                en0 = en + dim if en < 0 else min(en, dim - 1)
                idx[ax] = slice(st0, en0 if en0 >= 0 else None, sp)
    return x[tuple(idx)]


@_op("Split")
def _split(attrs, x, split=None):
    axis = int(attrs.get("axis", 0))
    if split is None and "split" in attrs:
        split = attrs["split"]
    sizes = [int(s) for s in split]
    offsets = np.cumsum(sizes)[:-1]
    return list(np.split(x, offsets, axis=axis))


@_op("Pad")
def _pad(attrs, x, pads, value=None):
    mode = attrs.get("mode", "constant")
    if mode != "constant":
        raise NotImplementedError(f"Pad mode {mode}")
    pads = [int(p) for p in pads]
    n = len(pads) // 2
    width = [(pads[i], pads[n + i]) for i in range(n)]
    cval = float(np.asarray(value).reshape(())) if value is not None else 0.0
    return np.pad(x, width, constant_values=cval).astype(x.dtype)


@_op("ReduceSum")
def _reduce_sum(attrs, x, axes=None):
    if axes is None:
        axes = attrs.get("axes")
    ax = tuple(int(a) for a in axes) if axes is not None else None
    return np.sum(x, axis=ax, keepdims=bool(attrs.get("keepdims", 1)), dtype=x.dtype)


@_op("ReduceMax")
def _reduce_max(attrs, x, axes=None):
    ax = tuple(int(a) for a in (axes if axes is not None else attrs.get("axes", []))) or None
    return np.max(x, axis=ax, keepdims=bool(attrs.get("keepdims", 1)))


@_op("ReduceMin")
def _reduce_min(attrs, x, axes=None):
    ax = tuple(int(a) for a in (axes if axes is not None else attrs.get("axes", []))) or None
    return np.min(x, axis=ax, keepdims=bool(attrs.get("keepdims", 1)))


@_op("ReduceMean")
def _reduce_mean(attrs, x, axes=None):
    ax = tuple(int(a) for a in (axes if axes is not None else attrs.get("axes", []))) or None
    return np.mean(x, axis=ax, keepdims=bool(attrs.get("keepdims", 1))).astype(x.dtype)


@_op("ReduceProd")
def _reduce_prod(attrs, x, axes=None):
    ax = tuple(int(a) for a in (axes if axes is not None else attrs.get("axes", []))) or None
    return np.prod(x, axis=ax, keepdims=bool(attrs.get("keepdims", 1)), dtype=x.dtype)


@_op("ArgMax")
def _argmax(attrs, x):
    ax = int(attrs.get("axis", 0))
    out = np.argmax(x, axis=ax).astype(np.int64)
    if attrs.get("keepdims", 1):
        out = np.expand_dims(out, ax)
    return out


@_op("ArgMin")
def _argmin(attrs, x):
    ax = int(attrs.get("axis", 0))
    out = np.argmin(x, axis=ax).astype(np.int64)
    if attrs.get("keepdims", 1):
        out = np.expand_dims(out, ax)
    return out


@_op("CumSum")
def _cumsum(attrs, x, axis):
    return np.cumsum(x, axis=int(np.asarray(axis).reshape(())), dtype=x.dtype)


@_op("TopK")
def _topk(attrs, x, k):
    k = int(np.asarray(k).reshape(()))
    axis = int(attrs.get("axis", -1))
    largest = int(attrs.get("largest", 1))
    order = -x if largest else x
    idx = np.argsort(order, axis=axis, kind="stable")
    idx = np.take(idx, range(k), axis=axis)
    vals = np.take_along_axis(x, idx, axis=axis)
    return [vals, idx.astype(np.int64)]


@_op("MatMul")
def _matmul(attrs, a, b):
    return np.matmul(a, b)


@_op("Gemm")
def _gemm(attrs, a, b, c=None):
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transA"):
        a = a.T
    if attrs.get("transB"):
        b = b.T
    y = alpha * (a @ b)
    if c is not None:
        y = y + beta * c
    return y.astype(a.dtype)


@_op("Softmax")
def _softmax(attrs, x):
    ax = int(attrs.get("axis", -1))
    e = np.exp(x - np.max(x, axis=ax, keepdims=True))
    return (e / np.sum(e, axis=ax, keepdims=True)).astype(x.dtype)


@_op("Flatten")
def _flatten(attrs, x):
    ax = int(attrs.get("axis", 1))
    lead = int(np.prod(x.shape[:ax])) if ax else 1
    return x.reshape(lead, -1)


@_op("MaxPool")
def _maxpool(attrs, x):
    kernel = [int(k) for k in attrs["kernel_shape"]]
    strides = [int(s) for s in attrs.get("strides", [1] * len(kernel))]
    dil = [int(d) for d in attrs.get("dilations", [1] * len(kernel))]
    pads = [int(p) for p in attrs.get("pads", [0] * (2 * len(kernel)))]
    xin = _pad_spatial(x, pads, -np.inf if x.dtype.kind == "f" else np.iinfo(x.dtype).min)
    view = _pool_view(xin, kernel, strides, dil)
    return view.max(axis=tuple(range(-len(kernel), 0))).astype(x.dtype)


@_op("AveragePool")
def _avgpool(attrs, x):
    kernel = [int(k) for k in attrs["kernel_shape"]]
    strides = [int(s) for s in attrs.get("strides", [1] * len(kernel))]
    pads = [int(p) for p in attrs.get("pads", [0] * (2 * len(kernel)))]
    if attrs.get("count_include_pad"):
        xin = _pad_spatial(x, pads, 0.0)
        view = _pool_view(xin, kernel, strides, [1] * len(kernel))
        return view.mean(axis=tuple(range(-len(kernel), 0))).astype(x.dtype)
    xin = _pad_spatial(x, pads, np.nan)
    view = _pool_view(xin, kernel, strides, [1] * len(kernel))
    return np.nanmean(view, axis=tuple(range(-len(kernel), 0))).astype(x.dtype)


@_op("GlobalAveragePool")
def _gap(attrs, x):
    return x.mean(axis=tuple(range(2, x.ndim)), keepdims=True).astype(x.dtype)


@_op("Conv")
def _conv(attrs, x, w, b=None):
    # x: [N, C, *S], w: [M, C/g, *K]
    n_sp = x.ndim - 2
    strides = [int(s) for s in attrs.get("strides", [1] * n_sp)]
    dil = [int(d) for d in attrs.get("dilations", [1] * n_sp)]
    pads = [int(p) for p in attrs.get("pads", [0] * (2 * n_sp))]
    groups = int(attrs.get("group", 1))
    kernel = list(w.shape[2:])
    xin = _pad_spatial(x, pads, 0.0)
    view = _pool_view(xin, kernel, strides, dil)  # [N, C, *out, *K]
    N, C = x.shape[0], x.shape[1]
    M = w.shape[0]
    out_sp = view.shape[2 : 2 + n_sp]
    cin_g, m_g = C // groups, M // groups
    outs = []
    for g in range(groups):
        vg = view[:, g * cin_g : (g + 1) * cin_g]  # [N, cin_g, *out, *K]
        wg = w[g * m_g : (g + 1) * m_g]  # [m_g, cin_g, *K]
        # contract cin_g and kernel dims
        axes_v = [1] + list(range(2 + n_sp, 2 + 2 * n_sp))
        axes_w = [1] + list(range(2, 2 + n_sp))
        og = np.tensordot(vg, wg, axes=(axes_v, axes_w))  # [N, *out, m_g]
        outs.append(np.moveaxis(og, -1, 1))
    y = np.concatenate(outs, axis=1) if groups > 1 else outs[0]
    if b is not None:
        y = y + b.reshape((1, M) + (1,) * n_sp)
    return y.astype(x.dtype)


@_op("Gather")
def _gather(attrs, data, indices):
    return np.take(data, np.asarray(indices, np.int64), axis=int(attrs.get("axis", 0)))


@_op("GatherElements")
def _gather_elements(attrs, data, indices):
    return np.take_along_axis(data, np.asarray(indices, np.int64), axis=int(attrs.get("axis", 0)))


@_op("GatherND")
def _gather_nd(attrs, data, indices):
    b = int(attrs.get("batch_dims", 0))
    indices = np.asarray(indices, np.int64)
    k = indices.shape[-1]
    batch_shape = data.shape[:b]
    flat_data = data.reshape((-1,) + data.shape[b:]) if b else data[None]
    flat_idx = indices.reshape((-1,) + indices.shape[b:]) if b else indices[None]
    outs = []
    for i in range(flat_data.shape[0]):
        tup = tuple(np.moveaxis(flat_idx[i], -1, 0))
        outs.append(flat_data[i][tup])
    stacked = np.stack(outs)
    out_shape = batch_shape + indices.shape[b:-1] + data.shape[b + k :]
    return stacked.reshape(out_shape)


@_op("ScatterND")
def _scatter_nd(attrs, data, indices, updates):
    red = attrs.get("reduction", "none")
    out = np.copy(data)
    indices = np.asarray(indices, np.int64)
    k = indices.shape[-1]
    flat_idx = indices.reshape(-1, k)
    flat_upd = np.asarray(updates).reshape((flat_idx.shape[0],) + data.shape[k:])
    for i in range(flat_idx.shape[0]):
        tup = tuple(flat_idx[i])
        if red == "add":
            out[tup] += flat_upd[i]
        elif red == "none":
            out[tup] = flat_upd[i]
        else:
            raise NotImplementedError(f"ScatterND reduction {red}")
    return out


@_op("Resize")
def _resize(attrs, x, roi=None, scales=None, sizes=None):
    mode = attrs.get("mode", "nearest")
    if mode != "nearest":
        raise NotImplementedError("Resize mode " + mode)
    if sizes is not None:
        target = [int(s) for s in sizes]
    else:
        target = [int(round(d * float(s))) for d, s in zip(x.shape, scales)]
    # implemented indexing is asymmetric/floor; ONNX defaults (half_pixel +
    # round_prefer_floor) coincide with it ONLY for integer upscale factors —
    # refuse the combinations that would silently pick different pixels
    ctm = attrs.get("coordinate_transformation_mode", "half_pixel")
    nearest = attrs.get("nearest_mode", "round_prefer_floor")
    explicit_ok = ctm == "asymmetric" and nearest == "floor"
    integer_scale = all(t % d == 0 for d, t in zip(x.shape, target))
    if not (explicit_ok or integer_scale):
        raise NotImplementedError(
            f"Resize with coordinate_transformation_mode={ctm}/nearest_mode="
            f"{nearest} at non-integer scale is not implemented (asymmetric/"
            "floor indexing only)"
        )
    out = x
    for ax in range(x.ndim):
        if target[ax] == out.shape[ax]:
            continue
        idx = (np.arange(target[ax]) * out.shape[ax] // target[ax]).astype(np.int64)
        out = np.take(out, idx, axis=ax)
    return out
