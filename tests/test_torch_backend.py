"""AutoBackend, artifact val and predict, and the command line's export in the PyTorch port (engine/backend.py,
model.py, cli.py), on the CPU.

tests/fixtures/tiny.yaml fitted 60 epochs to a seeded set that is its own validation split
(``torch_port.trained_task_checkpoint``), so that ``val`` carries signal. Gates: every format loads
(``pt2``, ``pt2-int8``, ``onnx``, ``ckpt``, ``yaml``) and gives the live decode (exactly for ``pt2`` and the
checkpoint, within rtol 1e-4 / atol 1e-4 for the numpy runtime, within the int8 bound of tests/
test_int8.py for ``pt2-int8``); a JAX ``.onnx`` loads in the port's backend and gives the JAX runtime's
outputs exactly (the same numpy evaluation); ``YOLO(artifact).val()`` gives live ``val``'s metrics within
1e-6 and ``predict`` its rows as sets within rtol 1e-4 / atol 1e-3 px; a non-detect artifact's ``val`` is
refused; other suffixes raise.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import torch

from export_port import FIXTURES, assert_rows_match, family_yaml, inputs
from torch_port import share_cores, trained_task_checkpoint

share_cores()

TINY = str(FIXTURES / "tiny.yaml")
METRICS_TOL = 1e-6


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """(fitted facade on the CPU, its data YAML, a directory of its artifacts: pt2, pt2-int8 and onnx at 64 px,
    batch 4)."""
    from bsyolo_tpu_torch import YOLO

    root = tmp_path_factory.mktemp("backend")
    ckpt, data = trained_task_checkpoint(root, "detect", TINY, 60)
    m = YOLO(str(ckpt), device="cpu")
    arts = root / "arts"
    arts.mkdir()
    for fmt in ("pt2", "pt2-int8", "onnx"):
        m.export(format=fmt, imgsz=64, batch=4, output=str(arts / f"best.{fmt}"))
    return m, str(data), arts, ckpt


def _live_decode(m, x):
    from bsyolo_tpu_torch.nn.heads import decode_detections

    with torch.no_grad():
        nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()  # as a letterboxed batch
        return decode_detections(m.model(nchw), m.spec.head_strides, m.spec.nc).numpy()


@pytest.mark.parametrize("fmt", ["pt2", "pt2-int8", "onnx", "ckpt", "yaml"])
def test_autobackend_reads_every_format(fitted, fmt):
    from bsyolo_tpu_torch.engine.backend import AutoBackend

    m, _, arts, ckpt = fitted
    path = {"ckpt": ckpt, "yaml": TINY}.get(fmt) or arts / f"best.{fmt}"
    b = AutoBackend(path, imgsz=64, device="cpu")
    assert b.kind == {"pt2-int8": "pt2"}.get(fmt, fmt) and b.device.type == "cpu"
    x = inputs(64, 4, seed=2)
    got = b(x).numpy()
    if fmt == "yaml":  # a fresh seeded graph: the shape only
        assert got.shape == _live_decode(m, x).shape[:2] + (4 + 2,)
        return
    want = _live_decode(m, x)
    if fmt in ("pt2", "ckpt"):
        np.testing.assert_array_equal(got, want)
    elif fmt == "onnx":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        rel = float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))
        assert 0 < rel < 0.1, rel
    assert b.warmup(4) is b


@pytest.mark.parametrize("name,match", [("best.stablehlo", "JAX package"), ("best.engine", "unsupported artifact"),
                                        ("best.tflite", "JAX package")])
def test_autobackend_refuses_other_suffixes(name, match, tmp_path):
    from bsyolo_tpu_torch.engine.backend import AutoBackend

    with pytest.raises(ValueError, match=match):
        AutoBackend(tmp_path / name, device="cpu")


def test_jax_onnx_loads_in_the_port_backend(fitted, tmp_path):
    """The JAX package's ``.onnx`` of the fitted weights (the JAX facade reads the port's checkpoint) runs in
    the port's backend with the JAX sidecar, giving what the JAX runtime gives."""
    from bsyolo_tpu.model import YOLO as JaxYOLO
    from bsyolo_tpu.onnx import OnnxModule as JaxReader
    from bsyolo_tpu_torch.engine.backend import AutoBackend, artifact_contract

    _, _, _, ckpt = fitted
    art = JaxYOLO(str(ckpt)).export(format="onnx", imgsz=64, batch=4, output=str(tmp_path / "j.onnx"))
    b = AutoBackend(art, device="cpu")
    assert b.meta["input"] == "NHWC float32 [0,1] RGB" and artifact_contract(b, 4, 64)[:2] == (False, 2)
    x = inputs(64, 4, seed=3)
    np.testing.assert_array_equal(b(x).numpy(), JaxReader(art)(x)[0])


@pytest.mark.parametrize("fmt", ["pt2", "onnx"])
def test_artifact_val_equals_live_val(fitted, fmt):
    from bsyolo_tpu_torch import YOLO

    m, data, arts, _ = fitted
    live = m.val(data=data, batch=4, imgsz=64, verbose=False).results_dict
    art = YOLO(str(arts / f"best.{fmt}"), device="cpu")
    assert art.task == "detect" and art.names == m.names
    got = art.val(data=data, batch=8, verbose=False).results_dict  # the artifact's static batch 4 is used
    assert live["metrics/mAP50(B)"] > 0.5, live
    for k, v in live.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=METRICS_TOL, err_msg=k)


def test_artifact_predict_rows_match_live_predict(fitted):
    from bsyolo_tpu_torch import YOLO

    m, data, arts, _ = fitted
    src = str(Path(data).parent / "images" / "train")
    live = m.predict(src, imgsz=64, conf=0.05, batch=4)
    got = YOLO(str(arts / "best.pt2"), device="cpu").predict(src, conf=0.05)
    assert len(got) == len(live) == 8 and sum(len(r) for r in live) > 0
    for g, w in zip(got, live):
        gb, wb = g.boxes.data[None], w.boxes.data[None]
        assert_rows_match(np.asarray(gb), np.asarray(wb), rtol=1e-4, atol=1e-3)


def test_artifact_val_refuses_non_detect(tmp_path):
    from bsyolo_tpu_torch import YOLO

    m = YOLO(family_yaml("segment", tmp_path), device="cpu")
    art = m.export(format="onnx", imgsz=64, output=str(tmp_path / "seg.onnx"))
    with pytest.raises(ValueError, match="detect-family"):
        YOLO(art, device="cpu").val(data=str(FIXTURES / "bsyolo8" / "bsyolo8.yaml"))
    with pytest.raises(ValueError, match="needs the live graph"):
        YOLO(art, device="cpu").train(data="x.yaml")


def test_artifact_contract_probes_without_a_sidecar(fitted, tmp_path):
    """Without a sidecar the contract comes from a probe's width, as the JAX package reads it (a 2-class
    decode-only graph's width 6 reads as end to end there too)."""
    import shutil

    from bsyolo_tpu.engine.backend import AutoBackend as JaxBackend, artifact_contract as jax_contract
    from bsyolo_tpu_torch.engine.backend import AutoBackend, artifact_contract

    _, _, arts, _ = fitted
    shutil.copy(arts / "best.onnx", tmp_path / "bare.onnx")
    b = AutoBackend(tmp_path / "bare.onnx", device="cpu")
    assert b.meta == {}
    assert artifact_contract(b, 4, 64) == jax_contract(JaxBackend(str(tmp_path / "bare.onnx"), 64), 4, 64)


def test_cli_export_and_artifact_val(fitted, tmp_path, capsys, monkeypatch):
    from bsyolo_tpu_torch.cli import main

    _, data, _, ckpt = fitted
    monkeypatch.chdir(tmp_path)
    assert main(["export", f"model={ckpt}", "device=cpu", "format=onnx", "imgsz=64", "batch=4"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out == "best.onnx" and (tmp_path / "best.onnx").exists()
    assert json.loads((tmp_path / "best.onnx.json").read_text())["batch"] == 4
    assert main(["val", "model=best.onnx", f"data={data}", "device=cpu"]) == 0
    assert "metrics/mAP50(B)" in capsys.readouterr().out
    assert main(["export", f"model={ckpt}", "device=cpu", "imgsz=64"]) == 0  # pt2 by default
    assert os.path.exists(tmp_path / "best.pt2")
