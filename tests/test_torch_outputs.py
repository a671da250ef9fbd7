"""File outputs of predict and val, the predictor's reader thread, and the port on a machine without OpenCV.

The JAX facade and the port's share seeded weights on tiny.yaml (carried by
``state_dict_from_jax``) and run at imgsz 64 on the bundled bsyolo8 photos:

- ``predict(save_txt, save_conf, save_crop)``: the same files. The port
  letterboxes on its device and the JAX predictor on the host with OpenCV,
  byte for byte alike; the JAX predictor is given the port's letterbox here
  (its ``letterbox_image`` patched), so both graphs see one input by
  construction, and the outputs are held tight: label lines within
  1e-5 (6 decimals written), rows paired one to one within equal classes,
  crops byte-equal (JAX writes them with ``cv2.imwrite``, the port with its
  own encoder).
- ``embed``: both letterbox on the host with OpenCV's arithmetic; within rtol 1e-4.
- ``val(save_json, save_txt)``: the same image ids and categories, boxes
  within 1e-3 px, scores rtol 1e-5, rows paired within equal classes.
- A JPEG carrying Exif orientation 6: the port's predictions.json equals the
  one for the same pixels saved upright as a PNG; the JAX package's does not
  (it un-letterboxes with PIL's stored size, before the rotation).

The card's machine has no OpenCV and no PIL: a subprocess that refuses both
trains, validates and predicts on bsyolo8 with the port, and its crops decode
to the arrays cv2 gives; a tiny segment graph's ``save_txt`` writes its mask
polygons there too (the port's own border follower).
"""

import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_port import port_module_from_jax, random_variables, to_plain_dict, variable_shapes  # noqa: E402

cv2 = pytest.importorskip("cv2")

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "tests" / "fixtures" / "tiny.yaml")
DATA = ROOT / "tests" / "fixtures" / "bsyolo8"
IMAGES = DATA / "images" / "train"
IMG = 64
CONF = 0.05


@pytest.fixture(scope="module")
def pair():
    """The JAX facade and the port's on tiny.yaml (nc 3, the bsyolo8 classes) with the same seeded weights."""
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu_torch import YOLO

    jm = JaxYOLO(TINY)
    variables = to_plain_dict(random_variables(variable_shapes(jm.model, (1, IMG, IMG, 3)), seed=10))
    jm.variables = {k: {**v} for k, v in variables.items()}
    port = YOLO(TINY, device="cpu")
    port_module_from_jax(port.model, variables)
    return jm, port


def pair_rows(got: np.ndarray, want: np.ndarray, tol) -> None:
    """Each row of ``got`` paired with its own row of ``want``: the same class (column 0 of a label line,
    ``cls`` of a json row), every other column within ``tol`` (a scalar, or one per column)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = np.broadcast_to(np.asarray(tol, float), got.shape[1:])
    free = np.ones(len(want), bool)
    for row in got:
        ok = free & (want[:, 0] == row[0]) & (np.abs(want[:, 1:] - row[1:]) <= tol[1:]).all(1)
        assert ok.any(), f"no row of the reference pairs with {row}"
        free[np.flatnonzero(ok)[0]] = False


def label_rows(path: Path) -> np.ndarray:
    return np.asarray([[float(v) for v in line.split()] for line in path.read_text().splitlines()]).reshape(-1, 6)


@pytest.fixture(scope="module")
def predicted(pair, tmp_path_factory):
    """Both facades' predict(save_txt, save_conf, save_crop) over the photos' directory at batch 3; ``embed``
    is passed too, and both facades give their results all the same."""
    import bsyolo_tpu.engine.predictor as jax_predictor
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    jm, port = pair
    root = tmp_path_factory.mktemp("predict")
    kw = dict(imgsz=IMG, conf=CONF, batch=3, save_txt=True, save_conf=True, save_crop=True, embed=[2, 4],
              project=str(root))

    def port_letterbox(frame, new_shape, *args, **kwargs):
        return np.ascontiguousarray(letterbox(frame, new_shape, "cpu").numpy()[::-1].transpose(1, 2, 0)), None, None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_predictor, "letterbox_image", port_letterbox)
        want = jm.predict(str(IMAGES), name="jax", **kw)
    got = port.predict(str(IMAGES), name="port", **kw)
    return root, got, want


def test_predict_rows_match_jax(predicted):
    _, got, want = predicted
    assert [r.path for r in got] == [r.path for r in want]
    assert sum(len(r) for r in got) > 40
    for g, w in zip(got, want):
        assert g.orig_shape == w.orig_shape
        wd = np.asarray(w.boxes.data)
        pair_rows(g.boxes.data[:, [5, 0, 1, 2, 3, 4]], wd[:, [5, 0, 1, 2, 3, 4]], [0, 1e-3, 1e-3, 1e-3, 1e-3, 1e-5])


def test_save_txt_matches_jax(predicted):
    root = predicted[0]
    names = sorted(p.name for p in (root / "jax" / "labels").glob("*.txt"))
    assert names == [f"{i}.txt" for i in range(8)]
    assert sorted(p.name for p in (root / "port" / "labels").glob("*.txt")) == names
    for n in names:
        pair_rows(label_rows(root / "port" / "labels" / n), label_rows(root / "jax" / "labels" / n), 1.01e-5)


def test_save_crop_matches_jax_byte_for_byte(predicted):
    root, got, _ = predicted
    want = sorted(p.relative_to(root / "jax" / "crops") for p in (root / "jax" / "crops").rglob("*.jpg"))
    have = sorted(p.relative_to(root / "port" / "crops") for p in (root / "port" / "crops").rglob("*.jpg"))
    assert have == want and len(want) == sum(len(r) for r in got)
    same = sum((root / "port" / "crops" / p).read_bytes() == (root / "jax" / "crops" / p).read_bytes() for p in want)
    assert same == len(want)


def test_results_summary_and_json_match_jax(predicted):
    _, got, want = predicted
    for norm in (False, True):
        g, w = got[0].summary(norm), want[0].summary(norm)
        assert [(r["name"], r["class"]) for r in g] == [(r["name"], r["class"]) for r in w]
        for a, b in zip(g, w):
            assert abs(a["confidence"] - b["confidence"]) <= 1e-5
            assert all(abs(a["box"][k] - b["box"][k]) <= (1e-4 if norm else 0.011) for k in a["box"])
    assert len(json.loads(got[0].to_json())) == len(got[0])


def test_embed_matches_jax(pair):
    jm, port = pair
    for layers in (None, [2, 4]):
        want = jm.embed(str(IMAGES), embed=layers, imgsz=IMG)
        got = port.embed(str(IMAGES), embed=layers, imgsz=IMG)
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g.shape == np.asarray(w).shape and g.dtype == np.float32
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


def json_rows(path: Path):
    rows = json.loads(path.read_text())
    by_img = {}
    for r in rows:
        by_img.setdefault(r["image_id"], []).append([r["category_id"], *r["bbox"], r["score"]])
    return {k: np.asarray(v) for k, v in by_img.items()}


def assert_json_match(got: Path, want: Path):
    """Rows of two predictions.json files paired per image: boxes within 1e-3 px and scores within 1e-5 of
    each other before the file rounds them (boxes to 1e-3, scores to 1e-5), so one rounding unit on top."""
    g, w = json_rows(got), json_rows(want)
    assert sorted(g) == sorted(w)
    for k in w:
        pair_rows(g[k], w[k], [0, 2e-3, 2e-3, 3e-3, 3e-3, 2.01e-5])


@pytest.fixture(scope="module")
def validated(pair, tmp_path_factory):
    jm, port = pair
    root = tmp_path_factory.mktemp("val")
    kw = dict(data=str(DATA / "bsyolo8.yaml"), batch=8, imgsz=IMG, save_json=True, save_txt=True, save_conf=True)
    want = jm.val(save_dir=str(root / "jax"), **kw)
    got = port.val(save_dir=str(root / "port"), **kw)
    return root, got, want


def test_val_save_json_matches_jax(validated):
    root = validated[0]
    assert_json_match(root / "port" / "predictions.json", root / "jax" / "predictions.json")
    ids = {r["image_id"] for r in json.loads((root / "port" / "predictions.json").read_text())}
    assert ids == set(range(8))


def test_val_save_txt_matches_jax(validated):
    root, got, want = validated
    names = sorted(p.name for p in (root / "jax" / "labels").glob("*.txt"))
    assert len(names) == 8 and sorted(p.name for p in (root / "port" / "labels").glob("*.txt")) == names
    for n in names:
        pair_rows(label_rows(root / "port" / "labels" / n), label_rows(root / "jax" / "labels" / n), 1.01e-5)
    for k, v in want.results_dict.items():
        assert abs(got.results_dict[k] - v) <= 1e-6, k


def test_evaluate_json_matches_jax(validated, tmp_path):
    """utils/coco.py's evaluator on the val run's predictions.json against the bsyolo8 labels as COCO
    annotations: the JAX package's built-in evaluator's numbers (pycocotools is on neither side), and
    on the ground truths themselves as predictions."""
    from bsyolo_tpu.utils.coco import evaluate_json as jax_evaluate
    from bsyolo_tpu_torch.utils.coco import evaluate_json

    anns = []
    for i in range(8):
        h, w = cv2.imread(str(IMAGES / f"{i}.jpg")).shape[:2]
        for line in (DATA / "labels" / "train" / f"{i}.txt").read_text().splitlines():
            c, x, y, bw, bh = map(float, line.split())
            anns.append({"image_id": i, "category_id": int(c), "bbox": [(x - bw / 2) * w, (y - bh / 2) * h, bw * w, bh * h]})
    (tmp_path / "anno.json").write_text(json.dumps({"annotations": anns}))
    preds = validated[0] / "port" / "predictions.json"
    got, want = evaluate_json(tmp_path / "anno.json", preds, verbose=False), jax_evaluate(tmp_path / "anno.json", preds,
                                                                                         verbose=False)
    assert got == pytest.approx(want, abs=1e-12)
    (tmp_path / "gt.json").write_text(json.dumps([{**a, "score": 1.0} for a in anns]))
    perfect = evaluate_json(tmp_path / "anno.json", tmp_path / "gt.json", verbose=False)
    assert perfect == jax_evaluate(tmp_path / "anno.json", tmp_path / "gt.json", verbose=False)
    assert perfect["mAP50"] == pytest.approx(0.995) and perfect["mAP50-95"] == pytest.approx(0.995)  # 101-point AP


def _exif_orientation_6(data: bytes) -> bytes:
    import struct

    tiff = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1) + struct.pack("<HHIHH", 0x112, 3, 1, 6, 0)
    body = b"Exif\0\0" + tiff + struct.pack("<I", 0)
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


def _one_image_dataset(root: Path, name: str, write) -> Path:
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    write(root / "images" / name)
    shutil.copy(DATA / "labels" / "train" / "0.txt", root / "labels" / f"{Path(name).stem}.txt")
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images\nval: images\nnames:\n  0: car\n  1: person\n"
                                    "  2: motorcycle\n")
    return root / "data.yaml"


def test_exif_rotated_jpeg_gets_the_boxes_of_its_upright_pixels(pair, tmp_path):
    """A JPEG with Exif orientation 6 decodes rotated (both packages, as cv2.imread); the port maps its
    boxes back into the rotated image, as for the same pixels saved upright as a PNG. The JAX package
    takes PIL's stored (unrotated) size there, so its boxes for the JPEG differ from its PNG's."""
    from bsyolo_tpu_torch.data.imread import imread, imwrite_png

    jm, port = pair
    src = (IMAGES / "0.jpg").read_bytes()
    rotated = _exif_orientation_6(src)
    exif = _one_image_dataset(tmp_path / "exif", "0.jpg", lambda p: p.write_bytes(rotated))
    upright = _one_image_dataset(tmp_path / "upright", "0.png", lambda p: imwrite_png(p, imread(tmp_path / "exif" / "images" / "0.jpg")))
    assert imread(tmp_path / "exif" / "images" / "0.jpg").shape == (320, 427, 3)
    kw = dict(batch=8, imgsz=IMG, save_json=True)
    for name, data in (("exif", exif), ("upright", upright)):
        port.val(data=str(data), save_dir=str(tmp_path / f"port_{name}"), **kw)
        jm.val(data=str(data), save_dir=str(tmp_path / f"jax_{name}"), **kw)
    assert_json_match(tmp_path / "port_exif" / "predictions.json", tmp_path / "port_upright" / "predictions.json")
    assert_json_match(tmp_path / "port_upright" / "predictions.json", tmp_path / "jax_upright" / "predictions.json")
    g, w = json_rows(tmp_path / "jax_exif" / "predictions.json"), json_rows(tmp_path / "jax_upright" / "predictions.json")
    assert g[0].shape == w[0].shape
    assert np.abs(g[0][:, 1:5] - w[0][:, 1:5]).max() > 1.0  # the JAX package's fault: PIL's size, unrotated


# --- the reader thread ---------------------------------------------------------------------------------

def test_reader_rows_equal_at_batch_1_and_4(pair):
    """The same rows in the same order at batch 1 and 4 (the last batch of 4 padded), to the float rounding
    of a convolution over another batch size (as tests/test_torch_predict.py holds a padded batch)."""
    port = pair[1]
    one = port.predict(str(IMAGES), imgsz=IMG, conf=CONF, batch=1)
    four = port.predict(str(IMAGES), imgsz=IMG, conf=CONF, batch=4)
    assert [r.path for r in one] == [r.path for r in four] == [str(p) for p in sorted(IMAGES.glob("*.jpg"))]
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a.boxes.data[:, 5], b.boxes.data[:, 5])
        np.testing.assert_allclose(b.boxes.data, a.boxes.data, rtol=1e-5, atol=1e-3)
    p = port.predictor
    assert 0 <= p.reader_wait <= p.wall


def test_early_break_releases_the_reader_and_closes_the_source(pair, monkeypatch):
    import bsyolo_tpu_torch.engine.predictor as predictor

    port = pair[1]
    closed = []

    def endless(source, vid_stride=1, stream_buffer=False):
        rng = np.random.default_rng(0)
        try:
            i = 0
            while True:
                yield rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), f"clip.mp4#frame{i}"
                i += 1
        finally:
            closed.append(True)

    monkeypatch.setattr(predictor, "iter_source", endless)
    gen = port.predict("clip.mp4", stream=True, imgsz=IMG, conf=CONF, batch=2)
    first = [next(gen) for _ in range(3)]
    assert [r.path for r in first] == ["clip.mp4#frame0", "clip.mp4#frame1", "clip.mp4#frame2"]
    gen.close()
    t0 = time.perf_counter()
    while any(t.name == "predict-reader" for t in threading.enumerate()) and time.perf_counter() - t0 < 1.0:
        time.sleep(0.01)
    assert not any(t.name == "predict-reader" for t in threading.enumerate())
    assert closed == [True]


def test_unreadable_file_raises_in_the_consumer(pair, tmp_path):
    from bsyolo_tpu_torch.data.imread import ImageFormatError

    port = pair[1]
    shutil.copy(IMAGES / "0.jpg", tmp_path / "a.jpg")
    (tmp_path / "b.jpg").write_bytes((IMAGES / "1.jpg").read_bytes()[:100])
    with pytest.raises(ImageFormatError, match="b.jpg"):
        port.predict(str(tmp_path), imgsz=IMG, conf=CONF, batch=1)
    assert not any(t.name == "predict-reader" for t in threading.enumerate())


def test_result_stems_follow_the_jax_layout(pair, tmp_path):
    """Array sources are image<i>, video frames <clip>_frame<n>, files their stem."""
    from bsyolo_tpu_torch.model import result_stem

    assert result_stem("array", 3) == "image3"
    assert result_stem("/v/clip.mp4#frame12", 0) == "clip_frame12"
    assert result_stem("/d/7.jpg", 5) == "7"
    port = pair[1]
    frames = [cv2.imread(str(IMAGES / "0.jpg")), cv2.imread(str(IMAGES / "1.jpg"))]
    port.predict(frames, imgsz=IMG, conf=CONF, save_txt=True, project=str(tmp_path), name="arr")
    assert sorted(p.name for p in (tmp_path / "arr" / "labels").iterdir()) == ["image0.txt", "image1.txt"]


# --- the card's machine, simulated: no OpenCV, no PIL --------------------------------------------------------

_NO_OPENCV = r'''
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
from pathlib import Path
from bsyolo_tpu_torch import YOLO

root = Path(sys.argv[1])
data = "tests/fixtures/bsyolo8/bsyolo8.yaml"
m = YOLO("tests/fixtures/tiny.yaml", device="cpu")
m.train(data=data, epochs=1, imgsz=64, batch=8, workers=0, plots=False, project=str(root), name="train")
metrics = m.val(data=data, imgsz=64, batch=8, save_json=True, save_txt=True, save_dir=str(root / "val"))
res = m.predict("tests/fixtures/bsyolo8/images/train", imgsz=64, conf=0.0001, save_txt=True, save_crop=True,
                project=str(root), name="pred")
vec = m.embed("tests/fixtures/bsyolo8/images/train", imgsz=64)
import torch
seg = YOLO("tests/fixtures/tinyseg.yaml", device="cpu")
with torch.no_grad():  # weights three times the seeded init's: masks that pass 0.5
    for p in seg.model.parameters():
        if p.ndim == 4:
            p.mul_(3.0)
seg_res = seg.predict("tests/fixtures/bsyolo8/images/train", imgsz=64, conf=0.0001, max_det=20, save_txt=True,
                      project=str(root), name="seg")
polygons = [len(line.split()) for f in sorted((root / "seg" / "labels").glob("*.txt")) for line in f.read_text().splitlines()]
assert len(polygons) == sum(len(r) for r in seg_res) > 0 and min(polygons) > 6 and all(n % 2 for n in polygons), polygons
assert "cv2" not in [k for k, v in sys.modules.items() if v is not None]
print(len(res), sum(len(r) for r in res), len(vec))
'''


def test_train_val_predict_embed_without_opencv_or_pil(tmp_path):
    from bsyolo_tpu_torch.data.imread import imread

    out = subprocess.run([sys.executable, "-c", _NO_OPENCV, str(tmp_path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    n_img, n_det, n_vec = map(int, out.stdout.strip().rsplit("\n", 1)[-1].split())
    assert n_img == n_vec == 8 and n_det > 0
    assert (tmp_path / "train" / "weights" / "last.ckpt").exists()
    assert len(list((tmp_path / "val" / "labels").glob("*.txt"))) == 8
    assert {r["image_id"] for r in json.loads((tmp_path / "val" / "predictions.json").read_text())} == set(range(8))
    assert len(list((tmp_path / "pred" / "labels").glob("*.txt"))) == 8
    crops = sorted((tmp_path / "pred" / "crops").rglob("*.jpg"))
    assert crops
    for c in crops[:40]:
        np.testing.assert_array_equal(imread(c), cv2.imread(str(c)))
