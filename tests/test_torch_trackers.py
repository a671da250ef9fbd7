"""The port's trackers (``bsyolo_tpu_torch/trackers``) against the JAX package's, on the CPU.

Both are host numpy and scipy, so each is held to the JAX package's output on
the same inputs: the Kalman filters to rtol 1e-6, the association costs and
assignments equal, ``BYTETracker`` and ``BOTSORT`` over a scripted 40-frame
detection sequence to rtol 1e-6 on their rows with track ids, classes and
detection indices equal. The sequence has births, motion with seeded jitter,
a track rescued by low-confidence detections, a track lost for four frames and
found again, a track removed after ``track_buffer`` frames, a one-frame
detection whose unconfirmed track is dropped, and low-confidence clutter.
``ColorHistEncoder`` (the port's HSV conversion and histogram, no OpenCV)
equals the JAX package's ``cv2.calcHist`` histogram exactly.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

N_FRAMES = 40
FRAME = 128
TRACK_BUFFER = 5  # frames a lost track is kept at frame_rate 30

# cx, cy, w, h, vx, vy, cls, conf, frames seen
_OBJECTS = (
    (20, 30, 16, 12, 1.5, 0.5, 0, 0.9, range(N_FRAMES)),  # always seen
    (90, 40, 14, 14, -1.0, 0.8, 1, 0.8, range(N_FRAMES)),  # low confidence in frames 10-14: rescued
    (50, 90, 18, 10, 0.5, -0.3, 0, 0.7, [i for i in range(N_FRAMES) if not 15 <= i <= 18]),  # lost, found again
    (100, 100, 12, 16, -0.5, -0.5, 2, 0.85, range(22)),  # gone after frame 21: removed after TRACK_BUFFER
    (30, 110, 15, 15, 1.0, -1.0, 1, 0.6, range(28, N_FRAMES)),  # born at frame 28
    (70, 70, 10, 10, 0.0, 0.0, 2, 0.9, [5]),  # one frame: an unconfirmed track, dropped
)
_COLORS = ((40, 40, 220), (220, 60, 40), (40, 200, 60), (200, 200, 40), (180, 40, 180), (240, 240, 240))


def scripted_sequence(seed: int = 0):
    """Per frame: (xywh (n, 4) float32, conf (n,), cls (n,), BGR frame (FRAME, FRAME, 3) uint8 on a
    textured background that drifts one pixel right per frame)."""
    rng = np.random.default_rng(seed)
    canvas = np.repeat(np.repeat(rng.integers(0, 120, (FRAME // 4 + N_FRAMES, FRAME // 4 + 2, 3)), 4, 0), 4, 1)
    out = []
    for i in range(N_FRAMES):
        rows = []
        for o, (cx, cy, w, h, vx, vy, c, conf, seen) in enumerate(_OBJECTS):
            if i not in seen:
                continue
            if o == 1 and 10 <= i <= 14:
                conf = 0.15
            rows.append([cx + vx * i + rng.normal(0, 0.3), cy + vy * i + rng.normal(0, 0.3), w + rng.normal(0, 0.2),
                         h + rng.normal(0, 0.2), c, conf + rng.uniform(-0.02, 0.02), o])
        for _ in range(rng.integers(0, 3)):  # clutter between the low and the high threshold
            rows.append([*rng.uniform(10, FRAME - 10, 2), *rng.uniform(6, 12, 2), 0, rng.uniform(0.11, 0.24), -1])
        rows = np.asarray(rows, np.float64)
        img = np.ascontiguousarray(canvas[:FRAME, i % 4: i % 4 + FRAME].astype(np.uint8))
        for cx, cy, w, h, _, _, o in rows:
            if o >= 0:
                img[int(cy - h / 2): int(cy + h / 2), int(cx - w / 2): int(cx + w / 2)] = _COLORS[int(o)]
        out.append((rows[:, :4].astype(np.float32), rows[:, 5].astype(np.float32), rows[:, 4].astype(np.float32), img))
    return out


def _run(tracker, seq, with_img: bool):
    return [tracker.update(xywh, conf, cls, img=img if with_img else None) for xywh, conf, cls, img in seq]


def _assert_tracks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g[:, 4:5], w[:, 4:5])  # track ids
        np.testing.assert_array_equal(g[:, 6:], w[:, 6:])  # class, detection index
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)


def _events(outs):
    """Track ids seen per frame (to show the sequence is not vacuous)."""
    return [set(o[:, 4].astype(int)) for o in outs]


@pytest.mark.parametrize("kind", ["XYAH", "XYWH"])
def test_kalman_filters_match_jax(kind):
    from bsyolo_tpu.trackers import kalman as jk
    from bsyolo_tpu_torch.trackers import kalman as pk

    jf, pf = getattr(jk, f"KalmanFilter{kind}")(), getattr(pk, f"KalmanFilter{kind}")()
    rng = np.random.default_rng(1)
    z0 = np.array([50.0, 40.0, 0.8 if kind == "XYAH" else 20.0, 25.0])
    (jm, jc), (pm, pc) = jf.initiate(z0), pf.initiate(z0)
    np.testing.assert_allclose(pm, jm, rtol=1e-6)
    np.testing.assert_allclose(pc, jc, rtol=1e-6)
    for i in range(20):
        (jm, jc), (pm, pc) = jf.predict(jm, jc), pf.predict(pm, pc)
        z = z0 + np.array([i * 1.5, -i, 0.0, 0.1 * i]) + rng.normal(0, 0.5, 4)
        (jm, jc), (pm, pc) = jf.update(jm, jc, z), pf.update(pm, pc, z)
        np.testing.assert_allclose(pm, jm, rtol=1e-6)
        np.testing.assert_allclose(pc, jc, rtol=1e-6, atol=1e-12)
        for a, b in zip(pf.project(pm, pc), jf.project(jm, jc)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
    means = np.stack([jm, jm * 1.1, jm * 0.9])
    covs = np.stack([jc, jc * 2, jc])
    for a, b in zip(pf.multi_predict(means, covs), jf.multi_predict(means, covs)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


class _Box:
    """What the cost functions read of a track or detection."""

    def __init__(self, xyxy, score, feat):
        self.xyxy, self.score, self.curr_feat, self.smooth_feat = xyxy, score, feat, feat


def test_association_costs_and_assignment_match_jax():
    from bsyolo_tpu.trackers import matching as jm
    from bsyolo_tpu_torch.trackers import matching as pm

    rng = np.random.default_rng(2)
    for n, m in ((5, 7), (6, 3), (0, 4), (3, 0), (8, 8)):
        xy = rng.uniform(0, 100, (n + m, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n + m, 2))], 1).astype(np.float32)
        feats = rng.normal(0, 1, (n + m, 16)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        objs = [_Box(b, s, f) for b, s, f in zip(boxes, rng.uniform(0.1, 1, n + m), feats)]
        a, b = objs[:n], objs[n:]
        cost = pm.iou_distance(a, b)
        np.testing.assert_array_equal(cost, jm.iou_distance(a, b))
        np.testing.assert_array_equal(pm.fuse_score(cost, b), jm.fuse_score(cost, b))
        for metric in ("cosine", "euclidean"):
            np.testing.assert_array_equal(pm.embedding_distance(a, b, metric), jm.embedding_distance(a, b, metric))
        for thresh in (0.3, 0.8, 1.0):
            got, want = pm.linear_assignment(cost, thresh), jm.linear_assignment(cost, thresh)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]


def test_bytetracker_matches_jax_over_the_scripted_sequence():
    from bsyolo_tpu.trackers import BYTETracker as JaxTracker
    from bsyolo_tpu_torch.trackers import BYTETracker

    seq = scripted_sequence()
    want = _run(JaxTracker(track_buffer=TRACK_BUFFER), seq, with_img=False)
    got = _run(BYTETracker(track_buffer=TRACK_BUFFER), seq, with_img=False)
    _assert_tracks_equal(got, want)
    ids = _events(got)
    assert ids[0] == {1, 2, 3, 4}  # births
    assert len(set().union(*ids[10:15])) >= 4 and all(len(s) >= 3 for s in ids[10:15])  # the rescued track stays
    c_id = next(int(r[4]) for r in got[14] if r[7] == 2)  # detection index 2: the third object
    assert c_id not in ids[16] and c_id in ids[20]  # lost, then found again under its id
    d_id = next(int(r[4]) for r in got[21] if r[6] == 2)
    assert all(d_id not in s for s in ids[22:])
    assert max(max(s) for s in ids if s) >= 6  # the born track


def test_color_hist_encoder_equals_opencv_histogram():
    from bsyolo_tpu.trackers import ColorHistEncoder as JaxEncoder
    from bsyolo_tpu_torch.trackers import ColorHistEncoder

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    img[10:40, 20:60] = (30, 200, 220)  # one hue: every pixel in one bin
    boxes = np.array([[20, 10, 60, 40], [0, 0, 128, 96], [-10, -5, 30, 20], [100, 80, 140, 120], [50, 50, 50, 60],
                      [5.7, 3.2, 77.9, 61.5]], np.float32)
    # all boxes; boxes whose union lies inside the frame; only boxes of no area; none
    for sel in (slice(None), [0, 5, 4], [4], []):
        got, want = ColorHistEncoder()(img, boxes[sel]), JaxEncoder()(img, boxes[sel])
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gmc", ["none", "sparseOptFlow"])
def test_botsort_matches_jax_over_the_scripted_sequence(gmc):
    from bsyolo_tpu.trackers import BOTSORT as JaxTracker
    from bsyolo_tpu_torch.trackers import BOTSORT

    seq = scripted_sequence(seed=5)
    kw = dict(track_buffer=TRACK_BUFFER, with_reid=gmc == "none", gmc_method=gmc)
    want = _run(JaxTracker(**kw), seq, with_img=True)
    got = _run(BOTSORT(**kw), seq, with_img=True)
    _assert_tracks_equal(got, want)
    assert sum(len(o) for o in got) > 100


@pytest.mark.parametrize("cfg", ["bytetrack.yaml", "botsort.yaml", "trackertest.yaml"])
def test_create_tracker_matches_jax(cfg):
    from bsyolo_tpu.trackers import create_tracker as jax_create
    from bsyolo_tpu_torch.trackers import create_tracker

    path = str(Path(__file__).parent / "fixtures" / cfg) if cfg == "trackertest.yaml" else cfg
    got, want = create_tracker(path), jax_create(path)
    assert type(got).__name__ == type(want).__name__
    for k in ("track_high_thresh", "track_low_thresh", "new_track_thresh", "match_thresh", "fuse_score",
              "max_time_lost", "proximity_thresh", "appearance_thresh", "with_reid"):
        assert getattr(got, k, None) == getattr(want, k, None), k
    assert (got.gmc is None) == (want.gmc is None)
    if got.gmc is not None:
        assert got.gmc.method == want.gmc.method


@pytest.mark.parametrize("kind", ["BYTETracker", "BOTSORT"])
def test_zero_size_detections_are_not_tracked(kind):
    """A detection of zero width or height (a predicted box clipped to a frame edge) has no aspect ratio:
    the JAX package's ByteTrack turns it into NaN rows and then raises in the next frame's assignment,
    and its BoT-SORT reports it once. The port tracks the other detections as the JAX package tracks
    them alone; their detection indices still count the zero-size rows."""
    import bsyolo_tpu.trackers as jt
    import bsyolo_tpu_torch.trackers as pt

    kw = {"gmc_method": "none"} if kind == "BOTSORT" else {}
    xywh = np.float32([[50, 50, 20, 0], [80, 80, 10, 12], [20, 30, 0, 10], [40, 90, 14, 9]])
    conf = np.float32([0.9, 0.8, 0.7, 0.6])
    port, jax_all, jax_sized = getattr(pt, kind)(**kw), getattr(jt, kind)(**kw), getattr(jt, kind)(**kw)
    sized = [1, 3]
    jax_failed = False
    for i in range(4):
        step = xywh + np.float32([i, 0, 0, 0])
        got = port.update(step, conf, np.zeros(4))
        want = jax_sized.update(step[sized], conf[sized], np.zeros(2))
        assert np.isfinite(got).all() and len(got) == 2
        np.testing.assert_array_equal(got[:, :7], want[:, :7])
        np.testing.assert_array_equal(got[:, 7], np.asarray(sized)[want[:, 7].astype(int)])
        try:
            out = jax_all.update(step, conf, np.zeros(4))
            jax_failed |= not np.isfinite(out).all() or len(out) != 2
        except ValueError:
            jax_failed = True
    assert jax_failed  # the JAX package's tracker does not track them as the port does
