"""The facade's drawn outputs against the JAX package's, on the CPU: ``predict(save=True)``, ``show=True``,
``track(save=True)`` and ``Results.plot`` / ``save_txt`` of every task.

The JAX facade and the port's share seeded weights (``state_dict_from_jax``) on
the tiny detector and the tiny Segment, Pose and OBB graphs at imgsz 64; both
draw through this host's OpenCV, so the drawings are compared byte for byte:

- ``predict(save=True)`` over the bundled bsyolo8 photos: the same file names,
  each saved JPEG byte-equal to the JAX facade's;
- over a short ``mp4v`` clip written here with cv2: the same files (one
  ``<stem>.mp4`` and, with ``save_frames``, ``<stem>_<n>.jpg``), the frame JPEGs
  byte-equal and the video's decoded frames equal;
- the ``show_labels``, ``show_conf``, ``show_boxes`` and ``line_width`` options;
- ``show=True``: without a display one warning, as the JAX facade's, and nothing
  shown; with ``DISPLAY`` set (``cv2.imshow`` and ``waitKey`` patched) the frames
  shown equal the JAX facade's;
- ``track(save=True)``: the saved JPEGs byte-equal, the track ids equal;
- ``Results.plot`` of rotated boxes (tracked too) and of class probabilities, and
  a segment result's ``save_txt``, byte-equal to the JAX ``Results``' on the same
  rows.
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_port import port_module_from_jax, random_variables, to_plain_dict, variable_shapes  # noqa: E402

cv2 = pytest.importorskip("cv2")

FIXTURES = Path(__file__).parent / "fixtures"
IMAGES = FIXTURES / "bsyolo8" / "images" / "train"
IMG = 64
CONF = 0.25
GRAPHS = {"detect": ("tiny.yaml", 10), "segment": ("tinyseg.yaml", 4), "pose": ("tinypose.yaml", 4),
          "obb": ("tinyobb.yaml", 4)}


def _facades(task: str):
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu_torch import YOLO

    yaml, seed = GRAPHS[task]
    jm = JaxYOLO(str(FIXTURES / yaml))
    variables = to_plain_dict(random_variables(variable_shapes(jm.model, (1, IMG, IMG, 3)), seed=seed))
    jm.variables = {k: {**v} for k, v in variables.items()}
    port = YOLO(str(FIXTURES / yaml), device="cpu")
    port_module_from_jax(port.model, variables)
    return jm, port


@pytest.fixture(scope="module")
def facades():
    cache = {}

    def get(task):
        if task not in cache:
            cache[task] = _facades(task)
        return cache[task]

    return get


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 5-frame 64x80 mp4v clip at 12 fps, written by cv2 from the photos."""
    path = tmp_path_factory.mktemp("clip") / "clip.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 12.0, (80, 64))
    assert w.isOpened()
    for i in range(5):
        w.write(cv2.resize(cv2.imread(str(IMAGES / f"{i}.jpg")), (80, 64)))
    w.release()
    return path


def _files(d: Path):
    return sorted(p.relative_to(d).as_posix() for p in d.rglob("*") if p.is_file())


def _same_jpegs(a: Path, b: Path) -> None:
    names = _files(a)
    assert names == _files(b) and names
    for n in names:
        if n.endswith(".jpg"):
            assert (a / n).read_bytes() == (b / n).read_bytes(), n


def _frames(path: Path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def _both(facades, task, source, root: Path, **kw):
    jm, port = facades(task)
    kw = dict(imgsz=IMG, conf=CONF, batch=4, project=str(root), **kw)
    return jm.predict(source, name="jax", **kw), port.predict(source, name="port", **kw)


@pytest.mark.parametrize("task", list(GRAPHS))
def test_saved_images_match_jax(facades, task, tmp_path):
    want, got = _both(facades, task, str(IMAGES), tmp_path, save=True)
    assert sum(len(r) for r in got) > 0 and len(got) == len(want) == 8
    _same_jpegs(tmp_path / "jax", tmp_path / "port")
    assert _files(tmp_path / "port") == [f"{i}.jpg" for i in range(8)]


@pytest.mark.parametrize("task", list(GRAPHS))
def test_saved_video_matches_jax(facades, task, clip, tmp_path):
    _both(facades, task, str(clip), tmp_path, save=True, save_frames=True)
    _same_jpegs(tmp_path / "jax", tmp_path / "port")
    assert _files(tmp_path / "port") == ["clip.mp4", *(f"clip_{i}.jpg" for i in range(5))]
    got, want = _frames(tmp_path / "port" / "clip.mp4"), _frames(tmp_path / "jax" / "clip.mp4")
    assert len(got) == len(want) == 5 and all(np.array_equal(g, w) for g, w in zip(got, want))
    cap = cv2.VideoCapture(str(tmp_path / "port" / "clip.mp4"))
    assert cap.get(cv2.CAP_PROP_FPS) == 12.0
    cap.release()


def test_video_without_save_frames_writes_the_video_alone(facades, clip, tmp_path):
    _, port = facades("detect")
    port.predict(str(clip), imgsz=IMG, save=True, project=str(tmp_path), name="p")
    assert _files(tmp_path / "p") == ["clip.mp4"] and len(_frames(tmp_path / "p" / "clip.mp4")) == 5


@pytest.mark.parametrize("options", [{"show_labels": False}, {"show_conf": False}, {"show_boxes": False},
                                     {"line_width": 1}, {"line_width": 4, "show_conf": False}],
                         ids=["no-labels", "no-conf", "no-boxes", "line_width-1", "line_width-4-no-conf"])
@pytest.mark.parametrize("task", ["detect", "segment"])
def test_plot_options_of_save_match_jax(facades, task, options, tmp_path):
    source = [cv2.imread(str(IMAGES / f"{i}.jpg")) for i in range(2)]
    _both(facades, task, source, tmp_path, save=True, **options)
    _same_jpegs(tmp_path / "jax", tmp_path / "port")
    _both(facades, task, source, tmp_path / "default", save=True)
    assert (tmp_path / "port" / "image0.jpg").read_bytes() != (tmp_path / "default" / "port" / "image0.jpg").read_bytes()


def test_video_writer_that_does_not_open_raises(facades, clip, tmp_path, monkeypatch):
    """The JAX facade writes nothing and says nothing where OpenCV cannot open the writer; the port raises,
    naming the codec."""
    _, port = facades("detect")

    class Closed:
        def __init__(self, *args):
            pass

        def isOpened(self):
            return False

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoWriter", Closed)
    with pytest.raises(RuntimeError, match="mp4v"):
        port.predict(str(clip), imgsz=IMG, save=True, project=str(tmp_path), name="p")


def test_show_without_a_display_warns_once(facades, monkeypatch, caplog):
    shown = []
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setattr(cv2, "imshow", lambda name, img: shown.append(img))
    jm, port = facades("detect")
    frames = [cv2.imread(str(IMAGES / f"{i}.jpg")) for i in range(3)]
    with caplog.at_level(logging.WARNING):
        port.predict(frames, imgsz=IMG, show=True)
        jm.predict(frames, imgsz=IMG, show=True)
    port_warnings = [r.getMessage() for r in caplog.records if r.name == "bsyolo_tpu_torch"]
    jax_warnings = [r.getMessage() for r in caplog.records if r.name == "bsyolo_tpu"]
    assert port_warnings == jax_warnings == ["show=True: no display available, skipping imshow"]
    assert shown == []


@pytest.mark.parametrize("task", ["detect", "obb"])
def test_show_with_a_display_matches_jax(facades, task, monkeypatch):
    calls = []
    monkeypatch.setenv("DISPLAY", ":99")
    monkeypatch.setattr(cv2, "imshow", lambda name, img: calls.append((name, img.copy())))
    monkeypatch.setattr(cv2, "waitKey", lambda delay: calls.append(delay) or -1)
    jm, port = facades(task)
    frames = [cv2.imread(str(IMAGES / f"{i}.jpg")) for i in range(3)]
    port.predict(frames, imgsz=IMG, conf=CONF, show=True, show_conf=False)
    got, calls[:] = list(calls), []
    jm.predict(frames, imgsz=IMG, conf=CONF, show=True, show_conf=False)
    assert len(got) == len(calls) == 6 and got[1::2] == calls[1::2] == [1, 1, 1]
    for (gn, g), (wn, w) in zip(got[::2], calls[::2]):
        assert gn == wn == "bsyolo" and np.array_equal(g, w)


def test_track_save_matches_jax(facades, tmp_path):
    jm, port = facades("detect")
    kw = dict(imgsz=IMG, tracker=str(FIXTURES / "trackertest.yaml"), save=True, project=str(tmp_path))
    source = [cv2.imread(str(IMAGES / f"{i}.jpg")) for i in (0, 0, 1, 1)]
    want = jm.track(source, name="jax", **kw)
    got = port.track(source, name="port", **kw)
    _same_jpegs(tmp_path / "jax", tmp_path / "port")
    assert _files(tmp_path / "port") == [f"image{i}.jpg" for i in range(4)]
    assert sum(len(r) for r in got) > 0 and got[-1].boxes.is_track
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes.id, np.asarray(w.boxes.id))


def test_stream_saves_nothing(facades, tmp_path):
    _, port = facades("detect")
    gen = port.predict(str(IMAGES), imgsz=IMG, save=True, stream=True, project=str(tmp_path), name="p")
    assert len(list(gen)) == 8 and not (tmp_path / "p").exists()


# --- Results.plot and save_txt on the same rows ----------------------------------------------------------------


def _obb_rows(rng, n: int, tracked: bool):
    xy = rng.uniform(10, 80, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    cols = [xy, wh]
    if tracked:
        cols.append(np.arange(1, n + 1, dtype=float)[:, None])
    cols += [rng.uniform(0.2, 1, (n, 1)), rng.integers(0, 3, (n, 1)), rng.uniform(-np.pi / 2, np.pi / 2, (n, 1))]
    return np.concatenate(cols, 1).astype(np.float32)


@pytest.mark.parametrize("tracked", [False, True], ids=["rows", "tracked-rows"])
def test_plot_of_rotated_boxes_matches_jax(tracked, tmp_path):
    from bsyolo_tpu.engine.results import Results as JResults

    from bsyolo_tpu_torch.engine.results import Results

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    rows = _obb_rows(rng, 6, tracked)
    names = {0: "plane", 1: "ship", 2: "harbor"}
    got, want = Results(img, "a.jpg", names, obb=rows), JResults(img, "a.jpg", names, obb=rows)
    assert got.obb.is_track == tracked
    for kw in ({}, {"labels": False}, {"conf": False, "line_width": 3}, {"boxes": False}):
        assert np.array_equal(got.plot(**kw), want.plot(**kw))
    assert not np.array_equal(got.plot(), img)
    got.save(tmp_path / "p.jpg")
    want.save(tmp_path / "j.jpg")
    assert (tmp_path / "p.jpg").read_bytes() == (tmp_path / "j.jpg").read_bytes()


def test_plot_of_class_probabilities_matches_jax():
    """The JAX plot draws nothing for class probabilities: the image comes back as it was."""
    from bsyolo_tpu.engine.results import Results as JResults

    from bsyolo_tpu_torch.engine.results import Results

    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    probs = rng.dirichlet(np.ones(10)).astype(np.float32)
    got, want = Results(img, "a.jpg", {i: f"c{i}" for i in range(10)}, probs=probs), JResults(
        img, "a.jpg", {i: f"c{i}" for i in range(10)}, probs=probs)
    out = got.plot()
    assert np.array_equal(out, want.plot()) and np.array_equal(out, img) and out is not img


@pytest.mark.parametrize("save_conf", [False, True])
def test_segment_save_txt_matches_jax(save_conf, tmp_path):
    """Polygon lines from the masks' largest contours, a box line where the mask is empty, byte-equal."""
    from bsyolo_tpu.engine.results import Results as JResults

    from bsyolo_tpu_torch.engine.results import Results

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    masks = np.zeros((3, 48, 64), np.float32)
    cv2.ellipse(masks[0], (20, 20), (12, 7), 25.0, 0, 360, 1.0, -1)
    masks[1, 30:40, 40:63] = 1.0
    masks[1, 2:5, 2:5] = 1.0  # a smaller second blob: the larger one is written
    boxes = np.float32([[8, 13, 32, 27, 0.9, 1], [2, 2, 63, 40, 0.6, 0], [5, 5, 9, 9, 0.3, 2]])
    got = Results(img, "a.jpg", {0: "a", 1: "b", 2: "c"}, boxes=boxes, masks=masks)
    want = JResults(img, "a.jpg", {0: "a", 1: "b", 2: "c"}, boxes=boxes, masks=masks)
    got.save_txt(tmp_path / "p.txt", save_conf=save_conf)
    want.save_txt(tmp_path / "j.txt", save_conf=save_conf)
    text = (tmp_path / "p.txt").read_text()
    assert text.encode() == (tmp_path / "j.txt").read_bytes()
    lines = text.splitlines()
    assert len(lines) == 3 and len(lines[0].split()) > 6 and len(lines[2].split()) == 5 + save_conf
