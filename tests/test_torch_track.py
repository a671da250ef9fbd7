"""``YOLO.track``, the CLI's ``track``, video and stream sources of the port against the JAX package.

The port and the JAX facade share seeded weights on tiny.yaml and see 64 x 64
frames at imgsz 64, which the letterbox copies without a resize, so the
detections agree to float rounding. Tracked rows are held within 1e-3 px and
rtol 1e-5, with track ids, classes and row order equal. NMS is class-agnostic
in these comparisons: with random weights most boxes come out once per class
with near-equal scores, and such duplicates tie in the tracker's IoU cost, so
its Hungarian matching would pick between them by float rounding.
``LoadStreams`` frames are byte-equal to the JAX package's (both decode with
OpenCV), in buffer mode, where no frame is dropped by timing.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_port import port_module_from_jax, random_variables, to_plain_dict, variable_shapes

TINY = str(Path(__file__).parent / "fixtures" / "tiny.yaml")
TRACKER_TEST = str(Path(__file__).parent / "fixtures" / "trackertest.yaml")
IMG = 64


def scene(i: int) -> np.ndarray:
    """Frame ``i`` of a 64 x 64 clip: two filled rectangles moving apart."""
    img = np.full((IMG, IMG, 3), 40, np.uint8)
    img[10 + i: 30 + i, 8 + 2 * i: 28 + 2 * i] = (60, 200, 230)
    img[40:56, 44 - i: 60 - i] = (220, 90, 40)
    return img


def write_clip(path, n: int = 16) -> str:
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (IMG, IMG))
    for i in range(n):
        vw.write(scene(i % 8))
    vw.release()
    return str(path)


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
    return jm, port


def assert_tracked_equal(got, want, min_rows: int = 20):
    assert len(got) == len(want)
    assert sum(len(r) for r in got) >= min_rows
    for g, w in zip(got, want):
        assert g.path == w.path
        gd, wd = g.boxes.data, np.asarray(w.boxes.data)
        assert gd.shape == wd.shape and g.boxes.is_track == w.boxes.is_track
        np.testing.assert_array_equal(gd[:, 4], wd[:, 4])  # track ids
        np.testing.assert_array_equal(gd[:, 6], wd[:, 6])
        np.testing.assert_allclose(gd[:, 5], wd[:, 5], rtol=1e-5, atol=0)
        np.testing.assert_allclose(gd[:, :4], wd[:, :4], rtol=0, atol=1e-3)


@pytest.mark.parametrize("tracker", ["bytetrack.yaml", "botsort.yaml", TRACKER_TEST], ids=["bytetrack", "botsort",
                                                                                          "trackertest"])
def test_track_frames_matches_jax(pair, tracker):
    jm, port = pair
    frames = [scene(i) for i in range(8)]
    kw = dict(imgsz=IMG, tracker=tracker, agnostic_nms=True)
    assert_tracked_equal(port.track(frames, **kw), jm.track(frames, **kw))


def test_track_video_with_vid_stride_matches_jax(pair, tmp_path):
    jm, port = pair
    clip = write_clip(tmp_path / "clip.mp4")
    kw = dict(imgsz=IMG, tracker="bytetrack.yaml", agnostic_nms=True, vid_stride=2)
    got = port.track(clip, **kw)
    assert len(got) == 8 and got[1].path == f"{clip}#frame2"
    assert_tracked_equal(got, jm.track(clip, **kw))
    assert len(port.predict(clip, imgsz=IMG, vid_stride=3)) == 6


def test_persist_and_the_tracked_boxes(pair):
    jm, port = pair
    frames = [scene(i) for i in range(4)]
    kw = dict(imgsz=IMG, tracker="bytetrack.yaml", agnostic_nms=True)
    runs = {}
    for name, m in (("port", port), ("jax", jm)):
        first = m.track(frames[:2], persist=False, **kw)
        cont = m.track(frames[2:], persist=True, **kw)  # the same tracker goes on
        fresh = m.track(frames[2:], persist=False, **kw)  # a new tracker: ids from 1 again
        runs[name] = first + cont + fresh
    assert_tracked_equal(runs["port"], runs["jax"])
    first, cont, fresh = runs["port"][:2], runs["port"][2:4], runs["port"][4:]
    assert set(cont[0].boxes.id) <= set(first[1].boxes.id) | {max(first[1].boxes.id) + 1}
    assert min(fresh[1].boxes.id) == 1
    b = cont[0].boxes
    assert b.is_track and b.data.shape[1] == 7 and b.data.dtype == np.float32
    np.testing.assert_array_equal(b.id, b.data[:, 4])
    np.testing.assert_array_equal(b.conf, b.data[:, 5])
    np.testing.assert_array_equal(b.cls, b.data[:, 6])
    np.testing.assert_allclose(b.xywh[:, 2:], b.xyxy[:, 2:] - b.xyxy[:, :2])
    untracked = port.predict(frames[0], imgsz=IMG)[0].boxes
    assert not untracked.is_track and untracked.id is None
    gen = port.track(frames, stream=True, **kw)
    assert not isinstance(gen, list) and len(list(gen)) == 4
    plot = cont[0].plot()
    assert plot.shape == frames[2].shape and not np.array_equal(plot, frames[2])


def test_cli_track(tmp_path, capsys):
    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.cli import main

    clip = write_clip(tmp_path / "clip.mp4", n=6)
    args = dict(imgsz=IMG, tracker=TRACKER_TEST, conf=0.0001)
    assert main(["track", f"model={TINY}", f"source={clip}", "device=cpu", f"project={tmp_path}"]
                + [f"{k}={v}" for k, v in args.items()]) == 0
    want = YOLO(TINY, device="cpu").track(clip, **args)
    assert capsys.readouterr().out.strip().endswith(f"6 frames, {sum(len(r) for r in want)} detections")
    assert all(r.boxes.is_track for r in want if len(r))


@pytest.mark.parametrize("kind", ["file", "streams"])
def test_load_streams_frames_equal_jax(tmp_path, kind):
    from bsyolo_tpu.data.streams import LoadStreams as JaxStreams
    from bsyolo_tpu_torch.data.streams import LoadStreams

    clip = write_clip(tmp_path / "clip.mp4", n=12)
    src = [clip]
    if kind == "streams":
        src = tmp_path / "cams.streams"
        src.write_text(f"{clip}\n{write_clip(tmp_path / 'b.mp4', n=10)}\n")
        src = str(src)
    frames = {}
    for name, cls in (("port", LoadStreams), ("jax", JaxStreams)):
        s = cls(src, vid_stride=2, buffer=True)
        try:
            frames[name] = [f for f, _ in s]
        finally:
            s.close()
        assert not any(t.is_alive() for t in s.threads)
    n = 6  # a drained stream may repeat its last frame once, depending on when its reader notices the end
    assert n <= len(frames["port"]) <= n + 1 and n <= len(frames["jax"]) <= n + 1
    for got, want in zip(frames["port"][:n], frames["jax"][:n]):
        assert len(got) == len(want) == len(src if kind == "file" else [0, 1])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_stream_sources_through_predict_close_their_readers(pair, tmp_path, monkeypatch):
    import bsyolo_tpu_torch.engine.predictor as predictor

    _, port = pair
    lst = tmp_path / "cams.streams"
    lst.write_text(write_clip(tmp_path / "clip.mp4", n=12) + "\n")
    opened = []

    class Recording(predictor.LoadStreams):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            opened.append(self)

    monkeypatch.setattr(predictor, "LoadStreams", Recording)
    gen = port.predict(str(lst), stream=True, imgsz=IMG, stream_buffer=True)
    first = next(gen)
    gen.close()  # an early stop releases the streams
    assert first.path == str(tmp_path / "clip.mp4") and len(opened) == 1
    assert not opened[0].running and not any(t.is_alive() for t in opened[0].threads)


def test_screenshots_are_refused_as_in_jax():
    """Neither machine has ``mss``: the JAX package refuses screen capture with ImportError, the port,
    which has not ported it, with NotImplementedError naming its ROADMAP item."""
    from bsyolo_tpu.data.streams import LoadScreenshots as JaxScreenshots
    from bsyolo_tpu_torch.data.streams import LoadScreenshots

    with pytest.raises(ImportError):
        JaxScreenshots("screen 0")
    with pytest.raises(NotImplementedError, match="item 26"):
        LoadScreenshots("screen 0")


@pytest.mark.parametrize("source,error", [("missing.jpg", FileNotFoundError), ("missing.streams", FileNotFoundError),
                                          ("bad.streams", ConnectionError)])
def test_a_bad_source_raises_as_jax(pair, tmp_path, source, error):
    jm, port = pair
    (tmp_path / "bad.streams").write_text(str(tmp_path / "nonexistent.mp4") + "\n")
    path = str(tmp_path / source)
    for m in (jm, port):
        with pytest.raises(error):
            m.predict(path, imgsz=IMG)
    assert port.predict(str(tmp_path / "missing.mp4"), imgsz=IMG) == [] == jm.predict(str(tmp_path / "missing.mp4"),
                                                                                       imgsz=IMG)
