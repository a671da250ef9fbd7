"""The port's binding of the native runtime support library (bsyolo_tpu_torch/utils/native.py) against the JAX
package's binding of the same source (bsyolo_tpu/utils/native.py), on seeded inputs.

Both load ``native/bsyolo_native.cpp``: the port builds it through ``kernels/build.py``'s host route into
``build/bsyolo_tpu_torch/`` (never beside the source). Gates: letterbox bytes and ratio, NMS rows and box
rescaling identical to the JAX binding's (the same C++ on the same inputs).
"""

import numpy as np
import pytest

from bsyolo_tpu.utils import native as J

from bsyolo_tpu_torch.kernels import build
from bsyolo_tpu_torch.utils import native as P


def test_native_library_builds_into_the_build_directory():
    P.load()
    lib = build._target("bsyolo_native")
    assert lib.exists() and lib.parent == build.BUILD_DIR and build.source("bsyolo_native").name == "bsyolo_native.cpp"


@pytest.mark.parametrize("hw,new", [((97, 131), (64, 64)), ((480, 640), (320, 320)), ((50, 20), (96, 64))])
def test_letterbox_matches_jax_binding(hw, new):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    (a, ra), (b, rb) = P.letterbox(img, new, 114), J.letterbox(img, new, 114)
    assert a.shape == (*new, 3) and ra == rb
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nc", [1, 7])
def test_nms_matches_jax_binding(nc):
    rng = np.random.default_rng(nc)
    n = 400
    preds = np.concatenate([rng.uniform(20, 300, (n, 2)), rng.uniform(5, 60, (n, 2)),
                            rng.beta(0.5, 2.0, (n, nc))], -1).astype(np.float32)
    got, want = P.nms(preds, 0.25, 0.5, 100), J.nms(preds, 0.25, 0.5, 100)
    assert got.shape[1] == 6 and len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_scale_boxes_matches_jax_binding():
    rng = np.random.default_rng(5)
    rows = np.concatenate([rng.uniform(0, 320, (20, 4)), rng.uniform(0, 1, (20, 2))], -1).astype(np.float32)
    np.testing.assert_array_equal(P.scale_boxes(rows.copy(), (320, 320), (480, 640)),
                                  J.scale_boxes(rows.copy(), (320, 320), (480, 640)))


def test_binding_checks_shapes():
    with pytest.raises(ValueError):
        P.nms(np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError):
        P.letterbox(np.zeros((3, 4), np.uint8))
