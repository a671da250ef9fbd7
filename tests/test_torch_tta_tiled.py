"""The port's TTA predict and tiled (SAHI-style) predict against bsyolo_tpu.

yolo11n with the same carried weights on both sides (tests/torch_port.py),
imgsz and tile 128, conf 0.001 so NMS works on every candidate.

- The TTA rescale (``scale_img``) against ``jax.image.resize(..., "bilinear")``
  and the 0.447 pad: within 1e-5.
- ``YOLO.predict(augment=True)`` against the JAX
  ``DetectionPredictor(augment=True)`` on frames that need no letterbox
  resize, and ``predict_tiled`` against the JAX ``predict_tiled(mesh=None)``
  on a frame several tiles wide: rows equal, classes equal, scores within
  rtol 1e-5, boxes within atol 1e-3 px (as tests/test_torch_predict.py).
  The resize differs from JAX's by up to 5e-6, so scores of the scaled passes
  may differ in their last bit; two kept rows whose scores agree within the
  rtol may then trade places, and the TTA comparison pairs rows one to one
  within such a run of equal scores instead of by position.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import jax_spec, nchw, port_module_from_jax, random_variables, variable_shapes

IMG = 128


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


def _assert_rows_match(got, want):
    assert got.shape == want.shape and len(got) > 50  # NMS kept many detections
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-3)


def _assert_rows_match_up_to_tied_order(got, want):
    """As _assert_rows_match, but a row may pair with any unpaired row of a score within rtol 1e-5."""
    assert got.shape == want.shape and len(got) > 50
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-5, atol=0)  # the score sequence, in order
    free = np.ones(len(want), bool)
    for row in got:
        ok = (free & (want[:, 5] == row[5]) & (np.abs(want[:, 4] - row[4]) <= 1e-5 * np.abs(want[:, 4]))
              & (np.abs(want[:, :4] - row[:4]).max(1) <= 1e-3))
        assert ok.any(), f"no JAX row matches {row}"
        free[np.flatnonzero(ok)[0]] = False


@pytest.mark.parametrize("ratio", [0.83, 0.67])
@pytest.mark.parametrize("hw", [(128, 128), (96, 160)], ids=["128x128", "96x160"])
def test_scale_img_matches_jax_resize_and_pad(ratio, hw):
    import math

    from bsyolo_tpu_torch.engine.predictor import scale_img

    x = np.random.default_rng(7).uniform(0, 1, (2, *hw, 3)).astype(np.float32)  # NHWC, as the JAX predictor
    ih, iw = hw
    nh, nw = int(ih * ratio), int(iw * ratio)
    want = jax.image.resize(jnp.asarray(x), (2, nh, nw, 3), method="bilinear")
    ph, pw = math.ceil(ih * ratio / 32) * 32 - nh, math.ceil(iw * ratio / 32) * 32 - nw
    want = np.asarray(jnp.pad(want, ((0, 0), (0, ph), (0, pw), (0, 0)), constant_values=0.447))
    got = scale_img(torch.from_numpy(nchw(x)), ratio, 32).numpy()
    assert got.shape == nchw(want).shape and got.shape[2] % 32 == 0 and got.shape[3] % 32 == 0
    np.testing.assert_allclose(got, nchw(want), rtol=0, atol=1e-5)


def test_predict_augment_matches_jax(pair):
    """Two frames that need no resize (96x128 and 128x128) in one batch of 2."""
    from bsyolo_tpu.engine.predictor import DetectionPredictor

    jmodel, spec, variables, port = pair
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)]
    want = DetectionPredictor(jmodel, spec, variables, conf=0.001, imgsz=IMG, batch=2, names=port.names,
                              augment=True)(frames)
    got = port.predict(frames, imgsz=IMG, conf=0.001, batch=2, augment=True)
    plain = port.predict(frames, imgsz=IMG, conf=0.001, batch=2)
    for g, w, p in zip(got, want, plain):
        _assert_rows_match_up_to_tied_order(g.boxes.data, np.asarray(w.boxes.data))
        assert g.boxes.data.shape != p.boxes.data.shape or not np.allclose(g.boxes.data, p.boxes.data)


@pytest.mark.parametrize("hw,tile,overlap", [((1080, 1920), 640, 0.2), ((720, 1280), 640, 0.2), ((500, 500), 640, 0.2),
                                             ((200, 300), 128, 0.2), ((256, 256), 128, 0.0), ((130, 400), 64, 0.5)])
def test_tile_grid_matches_jax(hw, tile, overlap):
    from bsyolo_tpu.engine.tiled import tile_grid as jgrid
    from bsyolo_tpu_torch.engine.tiled import tile_grid

    assert tile_grid(*hw, tile, overlap) == jgrid(*hw, tile, overlap)


def test_tile_grid_counts_at_640():
    from bsyolo_tpu_torch.engine.tiled import tile_grid

    assert len(tile_grid(1080, 1920, 640)) == 8 and len(tile_grid(720, 1280, 640)) == 6


def test_predict_tiled_matches_jax(pair):
    """A 200x300 frame in 128-px tiles with 20 % overlap: 2 x 3 tiles, the last
    row and column padded past the frame's edge."""
    from bsyolo_tpu.engine.tiled import predict_tiled as jtiled
    from bsyolo_tpu_torch.engine.tiled import predict_tiled

    jmodel, spec, variables, port = pair
    frame = np.random.default_rng(13).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    want = jtiled(jmodel, spec, variables, frame, tile=IMG, conf=0.001, max_det=200, mesh=None)
    got = predict_tiled(port.model, port.spec, frame, tile=IMG, conf=0.001, max_det=200)
    assert got.dtype == np.float32
    _assert_rows_match(got, np.asarray(want))
    assert got[:, 0].max() > 230 and got[:, 1].max() > 128  # only the last tile column and row reach there


def test_predict_tiled_with_a_mesh_raises(pair):
    from bsyolo_tpu_torch.engine.tiled import predict_tiled

    port = pair[3]
    with pytest.raises(NotImplementedError, match="queue 1, item 14"):
        predict_tiled(port.model, port.spec, np.zeros((64, 64, 3), np.uint8), tile=64, mesh=object())
