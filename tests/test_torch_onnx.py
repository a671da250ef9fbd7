"""The PyTorch port's ONNX writer and runtime (bsyolo_tpu_torch/onnx), against eager PyTorch and the JAX package.

The protobuf codec round-trips tensors of every dtype the writer emits (0-d ones too); each family of ATen
ops (elementwise, shapes, constants, reductions, sorting and gathers, products, convolutions and pooling,
normalizations, the while loop, the port's ``bsyolo::`` operators) lowers to ONNX nodes whose evaluation by
the port's numpy runtime matches the eager function, exactly where the arithmetic is exact (shapes,
gathers, integer and boolean ops) and within rtol 1e-5 / atol 1e-5 in float32 (the runtime's numpy sums
run in another order); the file is also read by the JAX package's ``OnnxModule``, an independent reader.
The tiny RT-DETR graph's ONNX (MSDeformAttn's gathers, GELU, the top-300 selection) matches the live graph
and the JAX ``.onnx`` of the same weights within rtol 1e-4 / atol 1e-4 (rows as sets); ``nms=True`` Detect
rows (the exported NMS's Loop) equal JAX's within the same tolerance; an op without a rule raises
``UnsupportedOp`` naming it. The other families: tests/test_torch_onnx_families.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import torch
import torch.nn.functional as F

from export_port import assert_rows_match, family_pair, inputs, jax_export
from torch_port import share_cores

share_cores()

RNG = np.random.default_rng(0)


def _roundtrip(fn, *args, tmp_path, exact=False):
    """Export ``fn(*args)`` to ONNX, evaluate it with both packages' runtimes, compare with eager PyTorch."""
    from bsyolo_tpu.onnx import OnnxModule as JaxReader
    from bsyolo_tpu_torch.onnx import OnnxModule, export_onnx

    path = export_onnx(fn, args, tmp_path / "f.onnx")
    with torch.no_grad():
        want = fn(*args)
    want = [w.numpy() for w in (want if isinstance(want, (tuple, list)) else (want,))]
    feeds = [a.numpy() for a in args]
    for reader in (OnnxModule, JaxReader):
        got = reader(path)(*feeds)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, (reader, g.shape, w.shape, g.dtype, w.dtype)
            if exact or w.dtype.kind in "biu":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _f(*shape):
    return torch.from_numpy(RNG.normal(0, 1, shape).astype(np.float32))


# --- the protobuf codec ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64", "int32", "int8", "uint8", "bool"])
def test_proto_tensor_round_trip(dtype):
    from bsyolo_tpu_torch.onnx import proto

    for shape in ((), (1,), (2, 3, 4)):
        a = (RNG.normal(0, 50, shape)).astype(dtype)
        t = proto.decode(proto.encode(proto.tensor_from_numpy(a, "t"), "TensorProto"), "TensorProto")
        b = proto.tensor_to_numpy(t)
        assert b.shape == a.shape and b.dtype == a.dtype and t["name"] == "t"
        np.testing.assert_array_equal(a, b)


def test_proto_model_round_trip_and_jax_decoder():
    """A built model decodes to the same graph with the port's codec and the JAX package's."""
    from bsyolo_tpu.onnx import proto as jproto
    from bsyolo_tpu_torch.onnx import proto
    from bsyolo_tpu_torch.onnx.builder import GraphBuilder

    b = GraphBuilder("g")
    b.add_input("x", [2, 3], "float32")
    y = b.node("Mul", ["x", b.const_cached(np.float32(2.0))], outputs=["y"])[0]
    b.add_output(y, [2, 3], "float32")
    raw = b.model_bytes(doc="d")
    for codec in (proto, jproto):
        m = codec.decode(raw, "ModelProto")
        g = m["graph"]
        assert [n["op_type"] for n in g["node"]] == ["Mul"] and g["input"][0]["name"] == "x"
        assert m["opset_import"][0]["version"] == 13 and m["producer_name"] == "bsyolo_tpu_torch"
    assert proto.encode(proto.decode(raw, "ModelProto"), "ModelProto") == raw


# --- one lowering test per ATen op family ---------------------------------------------


def test_prim_elementwise(tmp_path):
    def fn(a, b):
        c = torch.sigmoid(a) * b - a / (b.abs() + 1) + torch.exp(-a.abs()) + torch.rsqrt(b * b + 1)
        d = torch.where(a > b, torch.relu(a), F.gelu(b)) + torch.log(b.abs() + 1) + torch.cos(a) * torch.sin(b)
        e = torch.clamp(a, -0.5, 0.7) + torch.maximum(a, b) - torch.minimum(a, 0.1 * b) + torch.floor(a) + a.round()
        m = ((a >= 0) & ~(b < 0)) | (a == b)
        return c + d + e, m, a.ne(0.25), torch.remainder(torch.arange(12).reshape(3, 4) + 5, 3)

    _roundtrip(fn, _f(3, 4), _f(3, 4), tmp_path=tmp_path)


def test_prim_integer_division_and_casts(tmp_path):
    def fn(a, b):
        ia = (a * 10).to(torch.int64)
        return torch.div(ia, 3, rounding_mode="floor"), torch.div(ia, 4, rounding_mode="trunc"), ia.float() / 2, \
            (ia % 5).to(torch.int32), b.double() * 3, (b > 0).to(torch.uint8)

    _roundtrip(fn, _f(4, 5), _f(4, 5), tmp_path=tmp_path)


def test_prim_shapes(tmp_path):
    def fn(a):
        b = a.view(2, 3, 20).permute(2, 0, 1).reshape(20, 6)
        c = torch.cat([b[:, :2], b[:, 3:], b[:, 2:3].t().reshape(20, 1)], 1)
        s1, s2 = torch.split(a, [1, 3], dim=2)
        u = a.unsqueeze(0).expand(2, -1, -1, -1, -1).squeeze(1)
        return c, s1 + 1, s2[:, :, ::2], a.select(1, 2), u, a[..., 1:-1].transpose(0, 3), a.unfold(3, 3, 2)

    _roundtrip(fn, _f(2, 3, 4, 5), tmp_path=tmp_path, exact=True)


def test_prim_pad_pool_and_upsample(tmp_path):
    def fn(a):
        p = F.pad(a, (0, 1, 0, 1))
        q = F.max_pool2d(a, 5, 1, 2) + F.max_pool2d(p, 2, 2, 0).repeat_interleave(1, 0).sum()
        return q, F.interpolate(a, scale_factor=2, mode="nearest"), F.avg_pool2d(a, 2, 2), F.adaptive_avg_pool2d(a, 1)

    _roundtrip(fn, _f(2, 3, 6, 6), tmp_path=tmp_path)


def test_prim_constants_and_strided_views(tmp_path):
    def fn(a):
        g = torch.arange(6, dtype=torch.float32) + 0.5
        full = torch.full((2, 6), 3.0) * g
        return a + full, torch.zeros(3, dtype=torch.int64) + 2, torch.as_strided(a.mean(-1, keepdim=True), (2, 1), (1, 1))

    _roundtrip(fn, _f(2, 6), tmp_path=tmp_path)


def test_prim_reductions_and_softmax(tmp_path):
    def fn(a):
        b = a > 0.3
        return (a.mean((1, 2), keepdim=True), a.sum(-1), a.amax(1), a.prod(2), b.any(1), b.any(), a.argmax(2),
                torch.linalg.vector_norm(a, dim=-1, keepdim=True), torch.softmax(a, 1), torch.softmax(a, -1),
                torch.log_softmax(a, 2))

    _roundtrip(fn, _f(2, 3, 4), tmp_path=tmp_path)


def test_prim_sort_topk_and_gathers(tmp_path):
    def fn(a, idx):
        v, i = torch.sort(a, dim=-1, descending=True, stable=True)
        va, ia = torch.sort(a, dim=0, stable=True)
        tv, ti = torch.topk(a + torch.arange(7) * 0.01, 3, dim=1)  # distinct values: torch.topk orders ties freely
        g = torch.gather(a, 1, idx)
        return v, i, va, ia, tv, ti, g, a.index_select(1, idx[0]), a[:, idx[1]]

    # ties in the rows: a stable order keeps the lower index first
    a = torch.from_numpy(RNG.integers(0, 4, (3, 7)).astype(np.float32))
    _roundtrip(fn, a, torch.from_numpy(RNG.integers(0, 7, (3, 4))), tmp_path=tmp_path, exact=True)


def test_prim_products(tmp_path):
    def fn(a, b, w, bias):
        return a @ b, torch.bmm(a[None].expand(2, -1, -1), b[None].expand(2, -1, -1)), F.linear(a, w, bias)

    _roundtrip(fn, _f(3, 5), _f(5, 4), _f(6, 5), _f(6), tmp_path=tmp_path)


@pytest.mark.parametrize("kind", ["conv", "grouped", "transposed"])
def test_prim_convolutions(kind, tmp_path):
    torch.manual_seed(0)
    mod = {"conv": torch.nn.Conv2d(3, 8, 3, 2, 1, bias=False), "grouped": torch.nn.Conv2d(4, 8, 3, 1, 2, dilation=2, groups=4),
           "transposed": torch.nn.ConvTranspose2d(3, 5, 2, 2, 0, bias=True)}[kind].eval()
    _roundtrip(mod, _f(1, mod.in_channels, 9, 7), tmp_path=tmp_path)


def test_prim_normalizations(tmp_path):
    torch.manual_seed(1)
    bn, gn, ln = torch.nn.BatchNorm2d(4).eval(), torch.nn.GroupNorm(2, 4), torch.nn.LayerNorm(6, eps=1e-6)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1), bn.running_var.uniform_(0.5, 1.5), bn.weight.uniform_(0.5, 1.5)

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn, self.gn, self.ln = bn, gn, ln

        def forward(self, x):
            return self.bn(x), self.gn(x), self.ln(x)

    _roundtrip(M().eval(), _f(2, 4, 5, 6), tmp_path=tmp_path)


def test_prim_while_loop_nms_keep(tmp_path):
    """The exportable greedy keep (ops/nms.py) lowers to a Loop that keeps the eager keep's indices."""
    from bsyolo_tpu_torch.ops import nms as N

    iou = torch.from_numpy(RNG.uniform(0, 1, (2, 40, 40)).astype(np.float32))
    iou = (iou + iou.transpose(1, 2)) / 2
    valid = torch.from_numpy(RNG.uniform(0, 1, (2, 40)) > 0.2)
    _roundtrip(lambda i, v: N._greedy_keep(i, v, 0.5), iou, valid, tmp_path=tmp_path, exact=True)


@pytest.mark.parametrize("op", ["decode_xywh", "box_best", "int8_matmul"])
def test_prim_port_operators(op, tmp_path):
    """Each bsyolo:: operator lowers to the ONNX nodes of its plain version."""
    from bsyolo_tpu_torch.kernels import decode, int8_matmul

    if op == "int8_matmul":
        x = torch.from_numpy(RNG.integers(-127, 128, (9, 27)).astype(np.int8))
        w = torch.from_numpy(RNG.integers(-127, 128, (27, 5)).astype(np.int8))
        sw, sx = torch.rand(5) * 0.01, torch.tensor(0.02)
        _roundtrip(lambda a, b, c, d: int8_matmul.int8_matmul(a, b, c, d), x, w, sw, sx, tmp_path=tmp_path)
        return
    feats = [_f(2, 64 + 3, 4, 4) * 3, _f(2, 64 + 3, 2, 2) * 3]
    fn = getattr(decode, op)
    _roundtrip(lambda a, b: fn([a, b], [8, 16], 3), *feats, tmp_path=tmp_path)


def test_unsupported_op_names_the_op(tmp_path):
    from bsyolo_tpu_torch.onnx import UnsupportedOp, export_onnx

    with pytest.raises(UnsupportedOp, match=r"aten\.cumsum\.default"):
        export_onnx(lambda a: torch.cumsum(a, 0), (_f(4),), tmp_path / "x.onnx")


# --- graphs ------------------------------------------------------------------------------


def test_rtdetr_onnx_matches_live_graph_and_jax_onnx(tmp_path):
    from bsyolo_tpu.onnx import OnnxModule as JaxReader
    from bsyolo_tpu_torch.engine.exporter import ExportPredict, build_export_predict
    from bsyolo_tpu_torch.onnx import OnnxModule

    jy, port, imgsz = family_pair("rtdetr", tmp_path)
    art = port.export(format="onnx", imgsz=imgsz, output=str(tmp_path / "r.onnx"))
    x = inputs(imgsz, 1)
    got = OnnxModule(art)(x)[0]
    fn, _ = build_export_predict(port.spec, False)
    with torch.no_grad():
        live = ExportPredict(port.model.eval(), fn)(torch.from_numpy(x)).numpy()
    assert_rows_match(got, live, rtol=1e-4, atol=1e-4)
    want = JaxReader(jax_export(jy, "onnx", tmp_path / "j.onnx"))(x)[0]
    assert_rows_match(got, want, rtol=1e-4, atol=1e-4)


def test_nms_onnx_rows_match_jax_onnx(tmp_path):
    from bsyolo_tpu.onnx import OnnxModule as JaxReader
    from bsyolo_tpu_torch.onnx import OnnxModule

    jy, port, imgsz = family_pair("detect", tmp_path, seed=4)
    x = inputs(imgsz, 2, seed=5)
    art = port.export(format="onnx", imgsz=imgsz, batch=2, nms=True, output=str(tmp_path / "n.onnx"))
    model = OnnxModule(art)
    assert "Loop" in {n["op_type"] for n in model.nodes}
    got = model(x)[0]
    assert got.shape == (2, 300, 6) and (got[..., 4] > 0).any()
    want = JaxReader(jax_export(jy, "onnx", tmp_path / "j.onnx", batch=2, nms=True))(x)[0]
    assert_rows_match(got, want, rtol=1e-4, atol=1e-4)
