"""ONNX export of the PyTorch port's tiny graphs (detect, segment, pose, OBB, classify, v10, World; tests/
export_port.py; RT-DETR's in tests/test_torch_onnx.py) through its own writer (onnx/lower.py).

Gates: the port's ``.onnx`` evaluated by its numpy runtime matches the live port graph's predict outputs, and
the JAX package's ``.onnx`` of the same weights evaluated by the JAX runtime, within rtol 1e-4 / atol 1e-4
(float32 sums in another order; v10's end-to-end rows as sets); the JAX package's ``OnnxModule``, an
independent reader, gives the port's file the same outputs as the port's runtime, exactly.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import torch  # noqa: E402

from export_port import E2E, FAMILIES, assert_rows_match, family_pair, inputs, jax_export  # noqa: E402
from torch_port import share_cores  # noqa: E402

share_cores()


def _check(got, want, family):
    assert got.shape == want.shape, (got.shape, want.shape)
    if family in E2E:
        assert_rows_match(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "rtdetr"])
def test_onnx_matches_live_graph_and_jax_onnx(family, tmp_path):
    from bsyolo_tpu.onnx import OnnxModule as JaxReader
    from bsyolo_tpu_torch.engine.exporter import ExportPredict, build_export_predict
    from bsyolo_tpu_torch.onnx import OnnxModule

    jy, port, imgsz = family_pair(family, tmp_path)
    art = port.export(format="onnx", imgsz=imgsz, batch=2, output=str(tmp_path / "m.onnx"))
    x = inputs(imgsz, 2, seed=1)
    got = OnnxModule(art)(x)
    fn, _ = build_export_predict(port.spec, False)
    with torch.no_grad():
        live = ExportPredict(port.model.eval(), fn)(torch.from_numpy(x))
    live = [t.numpy() for t in (live if isinstance(live, tuple) else (live,))]
    assert len(got) == len(live) == (2 if family == "segment" else 1)
    for g, w in zip(got, live):
        _check(g, w, family)
    for g, w in zip(JaxReader(art)(x), got):  # an independent reader of the port's file
        np.testing.assert_array_equal(g, w)
    want = JaxReader(jax_export(jy, "onnx", tmp_path / "j.onnx", batch=2))(x)
    for g, w in zip(got, want):
        _check(g, w, family)
