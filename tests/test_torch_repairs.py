"""Three predict/load faults of the port, repaired, against the JAX package's YOLO facade.

- Glob sources: ``predict("…/images/*/*.jpg")`` gives the same Results, paths
  and order as the JAX facade; the rows are held as tests/test_torch_predict.py
  holds resized photos (the JAX predictor is given the port's letterboxed
  frames, byte-equal to OpenCV's): classes equal,
  scores within rtol 1e-5, boxes within 1e-3 px.
- Float frames: a float32 (h, w, 3) frame on the 0-255 scale is letterboxed
  as it is and divided by 255, as in the JAX predictor; the rows match at the
  same tolerances (the float resize agrees with OpenCV's to float rounding).
- ``.pt`` load: a checkpoint that pickles a whole module loads (after a
  warning, by a full unpickle) in both packages, and a state_dict missing a
  key loads with a warning naming how many parameters were not found, that
  parameter keeping its value.
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax.numpy as jnp
import torch

from torch_port import port_module_from_jax, random_variables, to_plain_dict, variable_shapes

TINY = str(Path(__file__).parent / "fixtures" / "tiny.yaml")
GLOB = str(Path(__file__).parent / "fixtures" / "bsyolo8" / "images" / "*" / "*.jpg")
IMG = 64


@pytest.fixture(scope="module")
def pair():
    """The JAX facade and the port's on tiny.yaml with the same seeded weights."""
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu_torch import YOLO

    jm = JaxYOLO(TINY)
    variables = to_plain_dict(random_variables(variable_shapes(jm.model, (1, IMG, IMG, 3)), seed=4))
    jm.variables = {k: {**v} for k, v in variables.items()}
    port = YOLO(TINY, device="cpu")
    port_module_from_jax(port.model, variables)
    return jm, port, variables


def _assert_rows_match(got, want):
    assert got.shape == want.shape and len(got) > 10
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-3)


def test_glob_source_matches_jax(pair):
    import cv2

    from bsyolo_tpu.engine.predictor import DetectionPredictor
    from bsyolo_tpu.ops.boxes import scale_boxes
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    jm, port, variables = pair
    want = jm.predict(GLOB, imgsz=IMG, conf=0.001, batch=4)
    got = port.predict(GLOB, imgsz=IMG, conf=0.001, batch=4)
    assert len(got) == len(want) == 8
    assert [r.path for r in got] == [r.path for r in want] == sorted(str(p) for p in Path(GLOB).parents[1].glob("*/*.jpg"))
    frames = [cv2.imread(r.path) for r in got]
    lbs = [np.ascontiguousarray(letterbox(f, (IMG, IMG), "cpu").numpy()[::-1].transpose(1, 2, 0)) for f in frames]
    rows = DetectionPredictor(jm.model, jm.spec, variables, conf=0.001, imgsz=IMG, batch=4, names=port.names)(lbs)
    for g, w, f in zip(got, rows, frames):
        w = np.asarray(w.boxes.data).copy()
        w[:, :4] = np.asarray(scale_boxes((IMG, IMG), jnp.asarray(w[:, :4]), f.shape[:2]))
        assert g.orig_shape == f.shape[:2]
        _assert_rows_match(g.boxes.data, w)


@pytest.mark.parametrize("hw", [(100, 120), (64, 64)], ids=["resized", "unresized"])
def test_float_frame_matches_jax(pair, hw):
    jm, port, _ = pair
    frame = np.random.default_rng(6).uniform(0, 255, (*hw, 3)).astype(np.float32)
    (want,) = jm.predict(frame, imgsz=IMG, conf=0.001)
    (got,) = port.predict(frame, imgsz=IMG, conf=0.001)
    assert got.orig_shape == hw
    _assert_rows_match(got.boxes.data, np.asarray(want.boxes.data))


def test_float_letterbox_keeps_float(pair):
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    frame = np.random.default_rng(7).uniform(0, 255, (30, 50, 3)).astype(np.float32)
    lb = letterbox(frame, (IMG, IMG), "cpu")
    assert lb.dtype == torch.float32 and lb.shape == (3, IMG, IMG)
    assert not torch.equal(lb, lb.round())  # not rounded to grey levels
    with pytest.raises(ValueError, match="uint8 or float32"):
        letterbox(frame.astype(np.float64), (IMG, IMG), "cpu")


def _jax_state_dict(jm):
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    return state_dict_from_jax({k: to_plain_dict(v) for k, v in jm.variables.items()})


def test_pickled_module_checkpoint_loads_in_both(pair, tmp_path, caplog):
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu_torch import YOLO

    saved = YOLO(TINY, device="cpu", seed=11).model
    path = tmp_path / "whole.pt"
    torch.save({"model": saved, "epoch": 3}, path)
    with caplog.at_level(logging.WARNING):
        jm = JaxYOLO(TINY).load(str(path))
        port = YOLO(TINY, device="cpu").load(path)
    assert sum("full unpickle" in r.getMessage() for r in caplog.records) == 2  # one warning per package
    want = {k: v for k, v in saved.state_dict().items() if not k.endswith("num_batches_tracked")}
    got_port, got_jax = port.model.state_dict(), _jax_state_dict(jm)
    for k, v in want.items():
        torch.testing.assert_close(got_port[k], v, rtol=0, atol=0)
        torch.testing.assert_close(got_jax[k], v, rtol=0, atol=0)


def test_state_dict_missing_a_key_loads_with_a_warning_in_both(pair, tmp_path, caplog):
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu_torch import YOLO

    src = YOLO(TINY, device="cpu", seed=12).model.state_dict()
    dropped = "model.2.cv1.conv.weight"
    path = tmp_path / "partial.pt"
    torch.save({"model": {k: v for k, v in src.items() if k != dropped}}, path)  # the JAX loader reads it there
    jm, port = JaxYOLO(TINY), YOLO(TINY, device="cpu")
    before_jax, before_port = _jax_state_dict(jm)[dropped], port.model.state_dict()[dropped].clone()
    with caplog.at_level(logging.WARNING):
        jm.load(str(path))
        port.load(path)
    msgs = [r.getMessage() for r in caplog.records if "params not found" in r.getMessage()]
    assert msgs == [f"weight import: 1 params not found in {path}"] * 2
    torch.testing.assert_close(port.model.state_dict()[dropped], before_port, rtol=0, atol=0)
    torch.testing.assert_close(_jax_state_dict(jm)[dropped], before_jax, rtol=0, atol=0)
    for k, v in src.items():
        if k != dropped and not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(port.model.state_dict()[k], v, rtol=0, atol=0)
            torch.testing.assert_close(_jax_state_dict(jm)[k], v, rtol=0, atol=0)
