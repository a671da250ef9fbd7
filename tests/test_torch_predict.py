"""The port's predict slice, YOLO(...).predict, against the JAX DetectionPredictor.

yolo11n with the same carried weights on both sides, imgsz 128, conf 0.001,
so NMS works on every candidate. Frames that need no resize (96x128 and
128x128) go through the same letterbox on both sides, so their detections
are compared row by row: classes equal, scores within rtol 1e-5, boxes
within atol 1e-3 px (as tests/test_kernels.py). A bundled photo goes
through the resize path: the port's letterbox is byte-equal to the OpenCV
one (tests/test_torch_ops.py), and the JAX predictor is given the port's own
letterboxed frame, its boxes scaled back with the JAX scale_boxes, so the
rest of the path is held to the same row-by-row tolerances.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax.numpy as jnp
import torch

from torch_port import jax_spec, port_module_from_jax, random_variables, variable_shapes

IMG = 128
PHOTO = Path(__file__).parent / "fixtures/bsyolo8/images/train/0.jpg"


@pytest.fixture(scope="module")
def pair():
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu_torch import YOLO

    spec = jax_spec("yolo11n.yaml")
    jmodel = DetectionGraph(spec)
    variables = random_variables(variable_shapes(jmodel, (1, IMG, IMG, 3)), seed=1)
    port = YOLO("yolo11n.yaml", device="cpu")
    port_module_from_jax(port.model, variables)
    return jmodel, spec, variables, port


@pytest.fixture(scope="module")
def frames():
    import cv2

    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), rng.integers(0, 256, (128, 128, 3), dtype=np.uint8),
            cv2.imread(str(PHOTO))]


@pytest.fixture(scope="module")
def results(pair, frames):
    """Both predictors over the three frames in one batch of 3. The JAX side
    gets the port's letterboxed photo (BGR, already 128 x 128) in its place."""
    from bsyolo_tpu.engine.predictor import DetectionPredictor
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    jmodel, spec, variables, port = pair
    port_lb = letterbox(frames[2], (IMG, IMG), "cpu").numpy()  # (3, H, W) RGB
    jax_frames = frames[:2] + [np.ascontiguousarray(port_lb[::-1].transpose(1, 2, 0))]
    want = DetectionPredictor(jmodel, spec, variables, conf=0.001, imgsz=IMG, batch=3, names=port.names)(jax_frames)
    got = port.predict(frames, imgsz=IMG, conf=0.001, batch=3)
    return want, got


def _assert_rows_match(got, want):
    assert got.shape == want.shape and len(got) > 50  # NMS kept many detections
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-3)


@pytest.mark.parametrize("i", [0, 1], ids=["96x128", "128x128"])
def test_frames_without_resize_match_jax(results, frames, i):
    want, got = results
    assert got[i].orig_shape == frames[i].shape[:2]
    assert got[i].names == want[i].names
    _assert_rows_match(got[i].boxes.data, np.asarray(want[i].boxes.data))


def test_resized_photo_matches_jax(results, frames):
    import cv2  # noqa: F401  (the JAX letterbox needs it)

    from bsyolo_tpu.ops.boxes import scale_boxes
    from bsyolo_tpu.ops.letterbox import letterbox_image
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    photo = frames[2]
    cv_lb = letterbox_image(photo, (IMG, IMG))[0][..., ::-1].transpose(2, 0, 1).astype(int)
    diff = np.abs(letterbox(photo, (IMG, IMG), "cpu").numpy().astype(int) - cv_lb)
    assert diff.max() <= 1 and diff.mean() < 0.15

    want, got = results
    w = np.asarray(want[2].boxes.data).copy()
    w[:, :4] = np.asarray(scale_boxes((IMG, IMG), jnp.asarray(w[:, :4]), photo.shape[:2]))
    assert got[2].orig_shape == photo.shape[:2]
    _assert_rows_match(got[2].boxes.data, w)


def test_results_api_matches_jax(results):
    """Boxes' views, len, indexing and the verbose line read the same rows alike."""
    want, got = results
    w, g = want[1], got[1]
    for attr in ("xyxy", "xywh", "xyxyn", "xywhn", "conf", "cls"):
        np.testing.assert_allclose(getattr(g.boxes, attr), np.asarray(getattr(w.boxes, attr)), rtol=1e-5, atol=1e-3)
    assert len(g) == len(w) and g.verbose_line == w.verbose_line
    np.testing.assert_array_equal(g[:3].boxes.data, g.boxes.data[:3])
    assert len(g.new(boxes=np.zeros((0, 6), np.float32))) == 0
    drawn = g.plot()
    assert drawn.shape == g.orig_img.shape and (drawn != g.orig_img).any()


def test_stream_and_padded_last_batch(pair, frames):
    """stream=True yields the same Results lazily; a last batch of 1 (padded to 2
    by repetition) gives the frame the same detections as a batch of its own."""
    port = pair[3]
    full = port.predict(frames[:2], imgsz=IMG, conf=0.001, batch=1)
    gen = port.predict(frames[:3], imgsz=IMG, conf=0.001, batch=2, stream=True)
    assert not isinstance(gen, list)
    streamed = list(gen)
    assert len(streamed) == 3
    for a, b in zip(full, streamed[:2]):
        np.testing.assert_allclose(b.boxes.data, a.boxes.data, rtol=1e-5, atol=1e-3)


def test_image_file_and_directory_sources(pair, frames):
    port = pair[3]
    (from_file,) = port.predict(str(PHOTO), imgsz=64, conf=0.001)
    (from_array,) = port.predict(frames[2], imgsz=64, conf=0.001)
    assert from_file.path == str(PHOTO) and from_array.path == "array"
    np.testing.assert_array_equal(from_file.boxes.data, from_array.boxes.data)
    from_dir = port.predict(PHOTO.parent, imgsz=64, conf=0.001, batch=4)
    assert [r.path for r in from_dir] == [str(p) for p in sorted(PHOTO.parent.glob("*.jpg"))]


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from bsyolo_tpu_torch import YOLO, select_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOLO("yolo11n.yaml")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        select_device("cuda")
    assert select_device("cpu") == torch.device("cpu")


def test_options_not_ported_raise(pair, frames):
    """``visualize`` is the one predict option of the JAX facade still to come (``save`` and ``show``
    are held in tests/test_torch_facade_outputs.py)."""
    from bsyolo_tpu_torch.model import _NOT_PORTED

    port = pair[3]
    assert set(_NOT_PORTED) == {"visualize"}
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 16"):
        port.predict(frames[0], imgsz=IMG, visualize=True)
    with pytest.raises(NotImplementedError, match="Segment graph"):  # retina_masks belongs to Segment graphs
        port.predict(frames[0], imgsz=IMG, retina_masks=True)
    with pytest.raises(TypeError, match="bogus"):
        port.predict(frames[0], imgsz=IMG, bogus=1)


def test_yolo11old_builds_and_predicts_with_80_classes(frames):
    from bsyolo_tpu_torch import YOLO

    m = YOLO("yolo11old.yaml", device="cpu")
    assert len(m.names) == 80
    (r,) = m.predict(frames[1], imgsz=64, conf=0.001, max_det=20)
    assert r.boxes.data.shape[1] == 6 and len(r) <= 20
    assert np.isfinite(r.boxes.data).all()
