"""The port's mask border follower (``ops/contours.py``) against ``cv2.findContours`` and the JAX ``Masks.xy``.

The follower must give OpenCV's contours (``RETR_EXTERNAL``, ``CHAIN_APPROX_SIMPLE``)
point for point and in OpenCV's order, because ``Masks.xy`` keeps the first
contour of the largest ``cv2.contourArea``: where areas tie (two equal blobs,
or every contour of area 0: single pixels, one-pixel lines, diagonal chains)
the order decides. Each mask is held three ways: every contour equal to
cv2's in order, its area equal to ``cv2.contourArea``, and the port's
``Masks.xy`` / ``xyn`` equal to the JAX package's (which calls cv2), all with
``np.array_equal``.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

cv2 = pytest.importorskip("cv2")


def _blobs(seed: int, shape=(48, 64), n: int = 5):
    """Seeded filled ellipses and rectangles, some overlapping, some touching the image's edge."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.uint8)
    for _ in range(n):
        cx, cy = int(rng.integers(0, shape[1])), int(rng.integers(0, shape[0]))
        if rng.uniform() < 0.5:
            ax = (int(rng.integers(1, 12)), int(rng.integers(1, 12)))
            cv2.ellipse(m, (cx, cy), ax, float(rng.uniform(0, 180)), 0, 360, 1, -1)
        else:
            m[cy:cy + int(rng.integers(1, 10)), cx:cx + int(rng.integers(1, 14))] = 1
    return m


def _case(name):
    m = np.zeros((10, 12), np.uint8)
    if name == "single pixels":
        m[[1, 3, 5, 8], [2, 9, 1, 6]] = 1
    elif name == "one-pixel lines":
        m[2, 1:8] = 1  # horizontal
        m[4:9, 5] = 1  # vertical, no neighbour of the first
        m[6, 0:3] = 1
    elif name == "diagonal-only neighbours":
        m[[1, 2, 3, 4], [1, 2, 3, 4]] = 1  # one 8-connected chain of area 0
        m[[1, 2, 3], [9, 8, 7]] = 1  # the other diagonal
        m[[7, 8], [2, 1]] = 1
    elif name == "hole with an island":
        m[1:9, 1:10] = 1
        m[3:7, 3:8] = 0
        m[4:6, 5] = 1  # the island: not an outer border of an outermost component
    elif name == "blobs on the four edges":
        m[0, 3:7] = 1
        m[9, 2:5] = 1
        m[3:6, 0] = 1
        m[2:9, 11] = 1
        m[4:7, 4:7] = 1
    elif name == "all ones":
        m[:] = 1
    elif name == "empty":
        pass
    elif name == "two blobs of equal area":
        m[1:4, 1:4] = 1
        m[5:8, 7:10] = 1
    elif name == "equal lines, the later first":
        m[1, 1:5] = 1
        m[7, 3:7] = 1
    elif name.startswith("seeded blobs"):
        m = _blobs(int(name.rsplit(" ", 1)[1]))
    return m


CASES = ["single pixels", "one-pixel lines", "diagonal-only neighbours", "hole with an island",
         "blobs on the four edges", "all ones", "empty", "two blobs of equal area", "equal lines, the later first",
         *(f"seeded blobs {s}" for s in range(4))]


def _check_against_opencv(m: np.ndarray) -> None:
    from bsyolo_tpu_torch.ops.contours import contour_area, find_external_contours

    want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    got = find_external_contours(m)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w), (g.reshape(-1, 2).tolist(), w.reshape(-1, 2).tolist())
        assert contour_area(g) == cv2.contourArea(w)


def _masks_xy_pair(masks: np.ndarray):
    from bsyolo_tpu.engine.results import Masks as JMasks

    from bsyolo_tpu_torch.engine.results import Masks

    shape = masks.shape[1:]
    return Masks(masks, shape), JMasks(masks, shape)


@pytest.mark.parametrize("name", CASES)
def test_contours_equal_opencv_in_order(name):
    _check_against_opencv(_case(name))


@pytest.mark.parametrize("name", CASES)
def test_masks_xy_equal_jax(name):
    """The largest contour (the first of the ties) and its normalized form, as the JAX package's cv2 picks."""
    m = _case(name).astype(np.float32)
    got, want = _masks_xy_pair(np.stack([m, 1.0 - m, m * 0.4]))  # 0.4 is below the 0.5 threshold: empty
    for g, w in zip(got.xy, want.xy):
        assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
    for g, w in zip(got.xyn, want.xyn):
        assert np.array_equal(g, w)
    assert got.xy[2].shape == (0, 2)


def test_contours_of_a_full_size_mask_equal_opencv():
    """A 480x640 mask of large and thin blobs, as the predictor's masks at a frame's size."""
    m = np.zeros((480, 640), np.uint8)
    cv2.ellipse(m, (300, 240), (200, 120), 30.0, 0, 360, 1, -1)
    cv2.circle(m, (300, 240), 40, 0, -1)  # a hole
    cv2.line(m, (0, 0), (639, 479), 1, 1)  # a one-pixel diagonal through it all
    m[100:110, 600:640] = 1
    _check_against_opencv(m)


@settings(max_examples=300, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(1, 12), st.integers(1, 12), st.floats(0.05, 0.95), st.integers(0, 2**31 - 1))
def test_random_small_masks_equal_opencv(h, w, p, seed):
    m = (np.random.default_rng(seed).uniform(size=(h, w)) < p).astype(np.uint8)
    _check_against_opencv(m)


def test_nonzero_values_are_foreground_and_the_input_is_not_changed():
    from bsyolo_tpu_torch.ops.contours import find_external_contours, largest_contour

    m = _case("seeded blobs 1")
    scaled = m * np.uint8(7)
    before = scaled.copy()
    for g, w in zip(find_external_contours(scaled), find_external_contours(m)):
        assert np.array_equal(g, w)
    assert np.array_equal(scaled, before)
    assert largest_contour(np.zeros((3, 4), bool)).shape == (0, 2)
    with pytest.raises(ValueError, match="2-D"):
        find_external_contours(np.zeros((2, 3, 4)))


@pytest.mark.parametrize("seed", range(4))
def test_masks_of_runs_and_views_equal_opencv(seed):
    """Masks of long runs at widths around multiples of 8 (the follower's scan skips 8 equal pixels at a time),
    given as a bool mask, a float mask and a transposed (non-contiguous) view: cv2's contours of the same
    pixels."""
    from bsyolo_tpu_torch.ops.contours import find_external_contours

    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(7, 40)), int(rng.integers(7, 70))
    m = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 12))):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        m[y:y + int(rng.integers(1, 6)), x:x + int(rng.integers(1, 30))] = 1 - int(rng.integers(0, 4) == 0)
    for given in (m.astype(bool), m.astype(np.float32) * 0.5, np.ascontiguousarray(m.T).T):
        got = find_external_contours(given)
        want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        assert len(got) == len(want) and all(np.array_equal(g, c) for g, c in zip(got, want))
    _check_against_opencv(np.ascontiguousarray(m.T))
