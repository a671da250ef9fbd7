"""Shared pieces of the export tests of the PyTorch port (tests/test_torch_{export,onnx,backend}.py): one tiny
graph of each ported family built by both packages on one set of seeded variables, a JAX exporter stand-in
for them, and a row matcher for the end-to-end outputs."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np

FIXTURES = Path(__file__).parent / "fixtures"
# family -> (graph YAML under tests/fixtures, or a writer of one; imgsz)
FAMILIES = {
    "detect": ("tiny.yaml", 64), "segment": ("tinyseg.yaml", 64), "pose": ("tinypose.yaml", 64),
    "obb": ("tinyobb.yaml", 64), "classify": ("tinycls.yaml", 32), "v10": ("tinyv10", 64),
    "rtdetr": ("tinydetr", 64), "world": ("tinyworld.yaml", 64),
}


def family_yaml(family: str, root) -> str:
    """The graph YAML of ``family``: a fixture, or written under ``root`` (tiny.yaml with a v10Detect head;
    the tiny RT-DETR graph of tests/rtdetr_port.py)."""
    name = FAMILIES[family][0]
    if name == "tinyv10":
        path = Path(root) / "tinyv10.yaml"
        path.write_text((FIXTURES / "tiny.yaml").read_text().replace(", Detect, [nc]]", ", v10Detect, [nc]]"))
        return str(path)
    if name == "tinydetr":
        from rtdetr_port import write_tiny_yaml

        return write_tiny_yaml(Path(root) / "tinydetr.yaml", nc=3)
    return str(FIXTURES / name)


def family_pair(family: str, root, seed: int = 0):
    """(JAX stand-in facade, port ``YOLO`` on the CPU, imgsz) of ``family`` on one set of seeded variables; a
    World graph of both packages bound to one seeded text (nc rows of 512)."""
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml
    from bsyolo_tpu.nn.model import DetectionGraph
    from torch_port import port_module_from_jax, random_variables, to_plain_dict, variable_shapes

    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.nn.model import bind_text

    path = family_yaml(family, root)
    imgsz = FAMILIES[family][1]
    d = load_model_yaml(path)
    jspec = parse_model_yaml(d, scale=d.get("scale", ""))
    jm = DetectionGraph(jspec)
    text = None
    if family == "world":
        rng = np.random.default_rng(seed + 11)
        text = rng.normal(size=(1, jspec.nc, 512)).astype(np.float32)
        text /= np.linalg.norm(text, axis=-1, keepdims=True)
    shapes = variable_shapes(jm, (1, imgsz, imgsz, 3))
    variables = to_plain_dict(random_variables(shapes, seed))
    port = YOLO(path, device="cpu")
    port_module_from_jax(port.model, variables)
    if text is not None:
        bind_text(port.model, text)
        port.txt_feats = text
    port._img_size = imgsz
    jax_yolo = SimpleNamespace(spec=jspec, model=jm, variables=variables, model_path=path, _img_size=imgsz,
                               txt_feats=text)
    return jax_yolo, port, imgsz


def jax_export(jax_yolo, fmt: str, out, batch: int = 1, nms: bool = False) -> str:
    """The JAX package's ``export_model`` of a ``family_pair`` stand-in."""
    from bsyolo_tpu.engine.exporter import export_model

    return export_model(jax_yolo, format=fmt, imgsz=jax_yolo._img_size, batch=batch, nms=nms, output=str(out))


def inputs(imgsz: int, batch: int = 1, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (batch, imgsz, imgsz, 3)).astype(np.float32)


def assert_rows_match(got: np.ndarray, want: np.ndarray, rtol: float, atol: float) -> None:
    """(B, n, 6) end-to-end rows equal as sets per image: each wanted row pairs with one row of the same class
    whose values lie within ``atol + rtol * |want|`` (rows whose scores nearly tie may come in either order)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    for g, w in zip(got, want):
        free = np.ones(len(g), bool)
        for row in w:
            ok = free & (g[:, 5] == row[5]) & np.all(np.abs(g - row) <= atol + rtol * np.abs(row), axis=1)
            assert ok.any(), f"no row of the same class within tolerance for {row}"
            free[np.flatnonzero(ok)[0]] = False


E2E = ("v10", "rtdetr")


def check_pt2_round_trip(family: str, root) -> None:
    """A ``pt2`` artifact of ``family``'s pair reloaded through ``AutoBackend``: the live port graph's predict
    outputs exactly, the JAX ``stablehlo`` artifact of the same weights within rtol 1e-4 / atol 1e-4
    (end-to-end rows as sets)."""
    import torch

    from bsyolo_tpu.engine.exporter import load_stablehlo
    from bsyolo_tpu_torch.engine.backend import AutoBackend
    from bsyolo_tpu_torch.engine.exporter import ExportPredict, build_export_predict

    jy, port, imgsz = family_pair(family, root)
    art = port.export(format="pt2", imgsz=imgsz, batch=2, output=str(Path(root) / "m.pt2"))
    x = inputs(imgsz, 2)
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    got = tuple(o.numpy() for o in as_tuple(AutoBackend(art, device="cpu")(x)))
    fn, _ = build_export_predict(port.spec, False)
    with torch.no_grad():
        live = tuple(o.numpy() for o in as_tuple(ExportPredict(port.model.eval(), fn)(torch.from_numpy(x))))
    assert len(got) == len(live) == (2 if family == "segment" else 1)
    for g, w in zip(got, live):
        np.testing.assert_array_equal(g, w)
    want = load_stablehlo(jax_export(jy, "stablehlo", Path(root) / "m.stablehlo", batch=2))(x)
    want = tuple(np.asarray(w) for w in (want if isinstance(want, (list, tuple)) else (want,)))
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if family in E2E:
            assert_rows_match(g, w, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
