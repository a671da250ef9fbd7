"""The facade's ``fuse``, ``reset_weights`` and ``info`` against bsyolo_tpu, on the CPU.

``fuse()`` returns the facade unchanged, as the JAX package's does (XLA folds
BatchNorm into the convolution's epilogue there). Gates: the head maps after
``fuse()`` within rtol 1e-4 of the JAX graph's (of each map's largest
magnitude) on yolo11n and tinyseg with the same seeded weights; yolo11n's
predict rows after ``fuse()`` against the JAX predictor's row by row (classes
equal, scores rtol 1e-5, boxes 1e-3 px, as tests/test_torch_predict.py holds
them); ``state_dict`` untouched; ``train()`` after ``fuse()`` equal to
``train()`` without it, bit for bit, and ``val`` after it within 1e-6 of the
other facade's metrics. ``info()`` equals the JAX
facade's on every tiny fixture graph the port builds; ``reset_weights()``
equals a fresh ``YOLO(model, seed=s)``.
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax.numpy as jnp
import torch

from torch_port import jax_spec, nchw, port_module_from_jax, random_variables, to_plain_dict, variable_shapes

FIXTURES = Path(__file__).parent / "fixtures"
TINY = str(FIXTURES / "tiny.yaml")
IMG = 64


def _pair(name: str, seed: int):
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu_torch import YOLO

    spec = jax_spec(name)
    jmodel = DetectionGraph(spec)
    variables = to_plain_dict(random_variables(variable_shapes(jmodel, (1, IMG, IMG, 3)), seed=seed))
    port = YOLO(name, device="cpu")
    port_module_from_jax(port.model, variables)
    return jmodel, spec, variables, port


@pytest.fixture(scope="module")
def detector():
    return _pair("yolo11n.yaml", seed=1)


def _levels(out):
    return out["feats"] if isinstance(out, dict) else out


@pytest.mark.parametrize("name", ["yolo11n.yaml", str(FIXTURES / "tinyseg.yaml")], ids=["yolo11n", "tinyseg"])
def test_fused_head_maps_match_jax(name):
    jmodel, _, variables, port = _pair(name, seed=2)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    assert port.fuse() is port
    with torch.no_grad():
        got = port.model(torch.from_numpy(nchw(x)))
    pairs = list(zip(_levels(got), _levels(want)))
    if isinstance(got, dict):
        pairs.append((got["proto"], want["proto"]))
    for g, w in pairs:
        w = nchw(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_fused_predict_rows_match_jax(detector):
    from bsyolo_tpu.engine.predictor import DetectionPredictor

    jmodel, spec, variables, port = detector
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)]
    want = DetectionPredictor(jmodel, spec, variables, conf=0.001, imgsz=IMG, batch=2, names=port.names)(frames)
    got = port.fuse().predict(frames, imgsz=IMG, conf=0.001, batch=2)
    for g, w in zip(got, want):
        g, w = g.boxes.data, np.asarray(w.boxes.data)
        assert g.shape == w.shape and len(g) > 20
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=1e-5, atol=0)
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-3)


def test_fuse_leaves_the_graph_and_its_state_dict(detector):
    """The facade's graph keeps its BatchNorms and its weights, and predict gives the rows it gave before."""
    port = detector[3]
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    frame = np.random.default_rng(1).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    want = port.predict(frame, imgsz=IMG, conf=0.01)[0].boxes.data
    got = port.fuse().predict(frame, imgsz=IMG, conf=0.01)[0].boxes.data
    after = port.model.state_dict()
    assert after.keys() == before.keys() and all(torch.equal(after[k], before[k]) for k in before)
    np.testing.assert_array_equal(got, want)


def test_train_after_fuse_equals_train_without(tmp_path):
    from bsyolo_tpu_torch import YOLO

    kw = dict(data=str(FIXTURES / "bsyolo8" / "bsyolo8.yaml"), epochs=1, imgsz=IMG, batch=8, nbs=8, workers=0,
              amp=False, plots=False, project=str(tmp_path))
    frame = np.random.default_rng(2).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    fused = YOLO(TINY, device="cpu").fuse()
    fused.predict(frame, imgsz=IMG)
    m_fused = fused.train(name="fused", **kw)
    plain = YOLO(TINY, device="cpu")
    m_plain = plain.train(name="plain", **kw)
    assert m_fused.results_dict == m_plain.results_dict
    a, b = fused.model.state_dict(), plain.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    got = fused.predict(frame, imgsz=IMG, conf=0.01)[0].boxes.data
    want = plain.predict(frame, imgsz=IMG, conf=0.01)[0].boxes.data
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    vkw = dict(data=kw["data"], imgsz=IMG, batch=8)
    got, want = fused.val(**vkw).results_dict, plain.val(**vkw).results_dict
    assert got.keys() == want.keys()
    np.testing.assert_allclose([float(v) for v in got.values()], [float(v) for v in want.values()], rtol=0, atol=1e-6)


INFO_GRAPHS = ["tiny.yaml", "tinyseg.yaml", "tinypose.yaml", "tinyobb.yaml", "tinycls.yaml"]


@pytest.mark.parametrize("name", INFO_GRAPHS)
def test_info_matches_jax(name, caplog):
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu_torch import YOLO

    path = str(FIXTURES / name)
    with caplog.at_level(logging.INFO):
        want = JaxYOLO(path).info()
        jax_lines = [r.getMessage() for r in caplog.records if r.name == "bsyolo_tpu"]
        got = YOLO(path, device="cpu").info()
        port_lines = [r.getMessage() for r in caplog.records if r.name == "bsyolo_tpu_torch"]
    assert got == want and got["parameters"] > 0
    assert port_lines[-1:] == jax_lines[-1:] == [f"{path}: {got['layers']} layers, {got['parameters']:,} parameters"]


def test_reset_weights_equals_a_fresh_facade(tmp_path):
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu_torch import YOLO

    m = YOLO(TINY, device="cpu", seed=5)
    with torch.no_grad():
        for p in m.model.parameters():
            p.add_(1.0)
    frame = np.random.default_rng(3).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    m.fuse().predict(frame, imgsz=IMG, half=True)
    assert m.reset_weights() is m
    assert m._half is None and m.predictor is None
    fresh = YOLO(TINY, device="cpu", seed=5)
    a, b = m.model.state_dict(), fresh.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.0.conv.weight"], YOLO(TINY, device="cpu", seed=6).model.state_dict()[
        "model.0.conv.weight"])
    assert m.info() == JaxYOLO(TINY).reset_weights().info()
    np.testing.assert_array_equal(m.predict(frame, imgsz=IMG, conf=0.001)[0].boxes.data,
                                  fresh.predict(frame, imgsz=IMG, conf=0.001)[0].boxes.data)
