"""The port's detect data pipeline (bsyolo_tpu_torch/data) against OpenCV, PIL and the JAX package.

- ``imread``: exact against ``cv2.imread`` on PNGs written by cv2, by PIL and
  by the port (grey, RGB, RGBA, 8-bit palette, every row filter, an odd
  width), on BMP and on ``.npy``; header sizes against PIL. PNGs of other bit
  depths raise ``ImageFormatError``.
- ``data/cv.py``: each op on the same input as its cv2 call. Exact: LUT,
  median blur, blur, RGB2GRAY, BGR2HSV, RGB2LAB, rotation matrix. The others within 1
  grey level on at least 99 % of bytes (float arithmetic where OpenCV uses
  fixed point; OpenCV 5's vector HSV2BGR truncates).
- Augment functions against their JAX twins, given the same generator
  state: flips, mosaic placement, letterbox padding and ``format_labels``
  exact; labels of the warp exact, its pixels within the op tolerance.
- Loader batches against ``bsyolo_tpu.data`` on a PNG dataset written here,
  imgsz 64, 2 epochs: with augmentation off, byte-identical batches; with
  mosaic, affine, HSV and flip on (mosaic on and off), ``cls``, ``bboxes``,
  ``mask`` and ``im_idx`` byte-identical and images within a mean of 0.5
  grey level with at least 95 % of bytes equal; batches from 2 workers equal
  batches from 0.
- The ``labels.cache.npz`` written by either package is read by the other.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

cv2 = pytest.importorskip("cv2")

from bsyolo_tpu_torch.data import cv as C  # noqa: E402
from bsyolo_tpu_torch.data.imread import image_size, imread, imwrite_png  # noqa: E402


def _scene(h=96, w=131, seed=0):
    """A smooth gradient image with a noisy band and flat rectangles, uint8 BGR."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(xx * 1.7 + yy * 0.4) % 256, (yy * 2.3) % 256, np.sin(xx / 7) * 100 + 128], -1).astype(np.uint8)
    img[h // 3 : h // 2] = rng.integers(0, 256, (h // 2 - h // 3, w, 3))
    img[5:20, 60:90] = (30, 200, 90)
    return img


def _residue(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return float(np.mean(d == 0)), float(np.mean(d <= 1)), int(d.max())


# --- imread -----------------------------------------------------------------------------------------


def _png_files(tmp_path):
    from PIL import Image

    files = []
    for name, im in (("scene", _scene()), ("noise", np.random.default_rng(1).integers(0, 256, (37, 53, 3), np.uint8))):
        rgb = Image.fromarray(np.ascontiguousarray(im[..., ::-1]))
        cv2.imwrite(str(tmp_path / f"{name}_cv.png"), im)
        cv2.imwrite(str(tmp_path / f"{name}_cv9.png"), im, [cv2.IMWRITE_PNG_COMPRESSION, 9])
        rgb.save(tmp_path / f"{name}_rgb.png")
        rgb.convert("RGBA").save(tmp_path / f"{name}_rgba.png")
        Image.fromarray(im[..., 0]).save(tmp_path / f"{name}_grey.png")
        rgb.convert("P").save(tmp_path / f"{name}_pal8.png")
        imwrite_png(tmp_path / f"{name}_port.png", im)
        imwrite_png(tmp_path / f"{name}_port_grey.png", im[..., 1])
        files += sorted(tmp_path.glob(f"{name}_*.png"))
    return files


def _filters(path):
    """The set of row filter types a PNG uses."""
    import zlib

    from bsyolo_tpu_torch.data.imread import _CHANNELS, _png_chunks

    chunks = list(_png_chunks(path.read_bytes()))
    w, h, depth, ctype = __import__("struct").unpack(">IIBB", chunks[0][1][:10])
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    stride = (w * _CHANNELS[ctype] * depth + 7) // 8
    return {raw[r * (stride + 1)] for r in range(h)}


def test_png_decode_is_exact(tmp_path):
    files = _png_files(tmp_path)
    used = set()
    for f in files:
        got, want = imread(f), cv2.imread(str(f))
        assert got.dtype == np.uint8 and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
        used |= _filters(f)
    assert used == {0, 1, 2, 3, 4}  # every row filter was undone somewhere


def test_png_of_other_bit_depths_raises(tmp_path):
    from PIL import Image

    from bsyolo_tpu_torch.data.imread import ImageFormatError

    im = _scene()
    rgb = Image.fromarray(np.ascontiguousarray(im[..., ::-1]))
    rgb.convert("P", palette=Image.ADAPTIVE, colors=4).save(tmp_path / "pal2.png", bits=2)
    Image.fromarray(im[..., 0]).convert("1").save(tmp_path / "bit.png")
    cv2.imwrite(str(tmp_path / "deep.png"), im.astype(np.uint16) * 257)
    for f, depth in (("pal2.png", 2), ("bit.png", 1), ("deep.png", 16)):
        with pytest.raises(ImageFormatError, match=f"bit depth {depth}:"):
            imread(tmp_path / f)


def test_bmp_and_npy_and_header_sizes(tmp_path):
    from PIL import Image

    im = _scene(61, 75)
    cv2.imwrite(str(tmp_path / "c.bmp"), im)
    cv2.imwrite(str(tmp_path / "g.bmp"), im[..., 2])
    Image.fromarray(np.ascontiguousarray(im[..., ::-1])).save(tmp_path / "p.bmp")
    for f in ("c.bmp", "g.bmp", "p.bmp"):
        np.testing.assert_array_equal(imread(tmp_path / f), cv2.imread(str(tmp_path / f)), err_msg=f)
    np.save(tmp_path / "a.npy", im)
    np.testing.assert_array_equal(imread(tmp_path / "a.npy"), im)
    cv2.imwrite(str(tmp_path / "j.jpg"), im)
    cv2.imwrite(str(tmp_path / "s.png"), im)
    for f in ("c.bmp", "g.bmp", "j.jpg", "s.png"):
        w, h = Image.open(tmp_path / f).size
        assert image_size(tmp_path / f) == (h, w), f
    assert image_size(tmp_path / "a.npy") == (61, 75)
    assert imread(tmp_path / "missing.png") is None


def test_jpeg_without_opencv_raises_naming_the_item(tmp_path, monkeypatch):
    """With OpenCV refused a JPEG decodes through the port's own codec, to cv2's array; the kinds the
    codec refuses (here arithmetic coding) raise ImageFormatError naming ROADMAP item 21."""
    from bsyolo_tpu_torch.data.imread import ImageFormatError

    cv2.imwrite(str(tmp_path / "j.jpg"), _scene())
    want = cv2.imread(str(tmp_path / "j.jpg"))
    data = (tmp_path / "j.jpg").read_bytes()
    sof = data.index(b"\xff\xc0")
    (tmp_path / "a.jpg").write_bytes(data[: sof + 1] + b"\xc9" + data[sof + 2 :])
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(imread(tmp_path / "j.jpg"), want)
    with pytest.raises(ImageFormatError, match="item 21"):
        imread(tmp_path / "a.jpg")


# --- data/cv.py -------------------------------------------------------------------------------------

EXACT = {
    "lut": (lambda im, t: C.lut(im, t), lambda im, t: cv2.LUT(im, t)),
    "median3": (lambda im, t: C.median_blur(im, 3), lambda im, t: cv2.medianBlur(im, 3)),
    "median5": (lambda im, t: C.median_blur(im, 5), lambda im, t: cv2.medianBlur(im, 5)),
    "median7": (lambda im, t: C.median_blur(im, 7), lambda im, t: cv2.medianBlur(im, 7)),
    "blur3": (lambda im, t: C.blur(im, 3), lambda im, t: cv2.blur(im, (3, 3))),
    "blur7": (lambda im, t: C.blur(im, 7), lambda im, t: cv2.blur(im, (7, 7))),
    "gray": (lambda im, t: C.rgb2gray(im), lambda im, t: cv2.cvtColor(im, cv2.COLOR_RGB2GRAY)),
    "bgr2hsv": (lambda im, t: C.bgr2hsv(im), lambda im, t: cv2.cvtColor(im, cv2.COLOR_BGR2HSV)),
    "rgb2lab": (lambda im, t: C.rgb2lab(im), lambda im, t: cv2.cvtColor(im, cv2.COLOR_RGB2LAB)),
    "resize-halve": (lambda im, t: C.resize(im, (im.shape[1] // 2, im.shape[0] // 2)),
                     lambda im, t: cv2.resize(im, (im.shape[1] // 2, im.shape[0] // 2), interpolation=cv2.INTER_LINEAR)),
    "resize-linear-down": (lambda im, t: C.resize(im, (113, 79)),
                           lambda im, t: cv2.resize(im, (113, 79), interpolation=cv2.INTER_LINEAR)),
    "resize-linear-up": (lambda im, t: C.resize(im, (251, 190)),
                         lambda im, t: cv2.resize(im, (251, 190), interpolation=cv2.INTER_LINEAR)),
    "resize-linear-grey": (lambda im, t: C.resize(im[..., 1], (97, 143)),
                           lambda im, t: cv2.resize(im[..., 1], (97, 143), interpolation=cv2.INTER_LINEAR)),
}


@pytest.mark.parametrize("op", list(EXACT))
def test_cv_op_is_exact(op):
    im = _scene(120, 160)
    table = np.random.default_rng(2).integers(0, 256, 256).astype(np.uint8)
    ours, theirs = EXACT[op]
    np.testing.assert_array_equal(ours(im, table), theirs(im, table))


def _affine(angle, scale, shear):
    m = np.eye(3, dtype=np.float32)
    m[:2] = cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=scale)
    m[0, 1] += shear
    m[0, 2], m[1, 2] = 41.5, -17.25
    return m


CLOSE = {
    "resize-linear-down": (lambda im: C.resize(im, (113, 79)),
                           lambda im: cv2.resize(im, (113, 79), interpolation=cv2.INTER_LINEAR)),
    "resize-linear-up": (lambda im: C.resize(im, (251, 190)),
                         lambda im: cv2.resize(im, (251, 190), interpolation=cv2.INTER_LINEAR)),
    "resize-area": (lambda im: C.resize(im, (97, 71), C.INTER_AREA),
                    lambda im: cv2.resize(im, (97, 71), interpolation=cv2.INTER_AREA)),
    "warp-affine": (lambda im: C.warp_affine(im, _affine(12, 0.8, 0.05)[:2], (150, 130)),
                    lambda im: cv2.warpAffine(im, _affine(12, 0.8, 0.05)[:2], dsize=(150, 130),
                                              borderValue=(114, 114, 114))),
    "warp-perspective": (lambda im: C.warp_perspective(im, _affine(-20, 1.3, 0) + np.float32([[0, 0, 0], [0, 0, 0],
                                                                                                [2e-4, -1e-4, 0]]),
                                                       (150, 130)),
                         lambda im: cv2.warpPerspective(im, _affine(-20, 1.3, 0) + np.float32([[0, 0, 0], [0, 0, 0],
                                                                                               [2e-4, -1e-4, 0]]),
                                                        dsize=(150, 130), borderValue=(114, 114, 114))),
    "hsv2bgr": (lambda im: C.hsv2bgr(cv2.cvtColor(im, cv2.COLOR_BGR2HSV)),
                lambda im: cv2.cvtColor(cv2.cvtColor(im, cv2.COLOR_BGR2HSV), cv2.COLOR_HSV2BGR)),
    "lab2rgb": (lambda im: C.lab2rgb(cv2.cvtColor(im, cv2.COLOR_RGB2LAB)),
                lambda im: cv2.cvtColor(cv2.cvtColor(im, cv2.COLOR_RGB2LAB), cv2.COLOR_LAB2RGB)),
    "clahe-lightness": (lambda im: C.clahe_gray(cv2.cvtColor(im, cv2.COLOR_RGB2LAB)[..., 0]),
                        lambda im: cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8)).apply(
                            cv2.cvtColor(im, cv2.COLOR_RGB2LAB)[..., 0])),
    "clahe": (lambda im: C.clahe(im), lambda im: _cv2_clahe(im)),
}


def _cv2_clahe(im):
    """bsyolo_tpu/data/photometric.py clahe, on an RGB image."""
    lab = cv2.cvtColor(im, cv2.COLOR_RGB2LAB)
    lab[..., 0] = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8)).apply(lab[..., 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


@pytest.mark.parametrize("op", list(CLOSE))
def test_cv_op_within_one_grey_level(op):
    im = _scene(120, 160)
    ours, theirs = CLOSE[op]
    got, want = ours(im), theirs(im)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    equal, within1, _ = _residue(got, want)
    assert within1 >= 0.99, (op, equal, within1)


def test_rotation_matrix_is_exact():
    for angle, scale in ((0, 1.0), (10, 0.7), (-33.3, 1.5)):
        np.testing.assert_array_equal(C.rotation_matrix_2d((0, 0), angle, scale),
                                      cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=scale))


# --- augment functions against their JAX twins --------------------------------------------------------


def _labels(rng, shape, n=3):
    h, w = shape
    x1 = rng.uniform(0, w * 0.6, n).astype(np.float32)
    y1 = rng.uniform(0, h * 0.6, n).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, w * 0.4, n), y1 + rng.uniform(8, h * 0.4, n)], -1).astype(np.float32)
    return rng.integers(0, 3, n).astype(np.float32), boxes


def test_mosaic_flip_letterbox_and_format_are_exact():
    import bsyolo_tpu.data.augment as J
    from bsyolo_tpu.ops.letterbox import letterbox_image as jletterbox

    import bsyolo_tpu_torch.data.augment as P
    from bsyolo_tpu_torch.ops.letterbox import letterbox_image

    rng = np.random.default_rng(0)
    imgs = [_scene(60 + 7 * i, 80 - 5 * i, i) for i in range(9)]
    labels = [_labels(rng, im.shape[:2]) for im in imgs]
    for fn, k in ((J.mosaic4, 4), (J.mosaic9, 9)):
        want = fn(imgs[:k], labels[:k], 64, np.random.default_rng(5))
        got = getattr(P, fn.__name__)(imgs[:k], labels[:k], 64, np.random.default_rng(5))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for flips in ((0.5, 0.5), (1.0, 0.0), (0.0, 1.0)):
        want = J.random_flip(imgs[0].copy(), labels[0][1].copy(), np.random.default_rng(7), *flips)
        got = P.random_flip(imgs[0].copy(), labels[0][1].copy(), np.random.default_rng(7), *flips)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    im = imgs[2][:50]  # 50 x 70: canvases it fits without scaling up, so the letterbox only pads
    for shape in ((77, 77), (50, 96), (96, 70)):
        for g, w in zip(letterbox_image(im, shape, scaleup=False), jletterbox(im, shape, scaleup=False)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    cls, boxes = labels[3]
    for g, w in zip(P.format_labels(imgs[3], cls, boxes, 5), J.format_labels(imgs[3], cls, boxes, 5)):
        np.testing.assert_array_equal(g, w)


def test_perspective_hsv_copy_paste_and_train_transform_match_jax():
    """Same generator state in, labels out bit-identical; pixels within the ops' tolerance."""
    import bsyolo_tpu.data.augment as J
    from bsyolo_tpu.cfg import DEFAULT_CFG_DICT

    import bsyolo_tpu_torch.data.augment as P

    rng = np.random.default_rng(1)
    imgs = [_scene(64, 64, i) for i in range(4)]
    labels = [_labels(rng, im.shape[:2]) for im in imgs]
    hyp = {**DEFAULT_CFG_DICT, "degrees": 10.0, "shear": 2.0, "copy_paste": 0.5}
    cases = [
        ("perspective", lambda M, g: M.random_perspective(imgs[0], *labels[0], g, degrees=10, shear=2,
                                                           perspective=1e-4)),
        ("affine", lambda M, g: M.random_perspective(imgs[1], *labels[1], g, degrees=5, border=(-16, -16))),
        ("hsv", lambda M, g: (M.random_hsv(imgs[2], g),)),
        ("copy-paste", lambda M, g: M.copy_paste(imgs[3].copy(), *labels[3], g)),
        ("train-mosaic", lambda M, g: M.train_transform(imgs, labels, 64, g, hyp, mosaic=True)),
        ("train-letterbox", lambda M, g: M.train_transform(imgs[:1], labels[:1], 64, g, hyp, mosaic=False)),
    ]
    for name, run in cases:
        got, want = run(P, np.random.default_rng(11)), run(J, np.random.default_rng(11))
        equal, within1, _ = _residue(got[0], want[0])
        assert got[0].shape == want[0].shape and equal >= 0.95 and within1 >= 0.99, (name, equal, within1)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_photometric_ops_match_jax():
    from bsyolo_tpu.data import photometric as J

    from bsyolo_tpu_torch.data import photometric as P

    im = np.ascontiguousarray(_scene(64, 96)[..., ::-1])
    for name in ("blur", "median_blur", "to_gray"):
        np.testing.assert_array_equal(getattr(P, name)(im), getattr(J, name)(im), err_msg=name)
    np.testing.assert_array_equal(P.photometric_suite(im, np.random.default_rng(0), p=1.0),
                                  J.photometric_suite(im, np.random.default_rng(0), p=1.0))


# --- datasets and loaders against bsyolo_tpu.data ------------------------------------------------------

NAMES = ("red", "green", "blue")


def write_dataset(root: Path, n_train=12, n_val=6, seed=0) -> Path:
    """A seeded PNG dataset of 64x64, 48x64 and 64x40 frames with 1 to 3 filled rectangles each."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            h, w = ((64, 64), (48, 64), (64, 40))[i % 3]
            img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            rows = []
            for _ in range(int(rng.integers(1, 4))):
                bw, bh = int(rng.integers(8, w // 2)), int(rng.integers(8, h // 2))
                x0, y0, c = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh)), int(rng.integers(0, 3))
                img[y0 : y0 + bh, x0 : x0 + bw] = (40 + 80 * c, 200 - 60 * c, 120)
                rows.append(f"{c} {(x0 + bw / 2) / w} {(y0 + bh / 2) / h} {bw / w} {bh / h}")
            imwrite_png(root / "images" / split / f"{i:03d}.png", img)
            (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    names = "".join(f"  {i}: {n}\n" for i, n in enumerate(NAMES))
    (root / "data.yaml").write_text(f"path: {root}\ntrain: images/train\nval: images/val\nnames:\n{names}")
    return root / "data.yaml"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("torch_data"))


def _loaders(data_yaml, augment, mosaic, workers=0, drop_last=True, rect=False, shuffle=True):
    import bsyolo_tpu.data as J
    from bsyolo_tpu.cfg import DEFAULT_CFG_DICT

    import bsyolo_tpu_torch.data as P

    split = "train" if augment else "val"
    out = []
    for M in (J, P):
        d = M.load_dataset_yaml(data_yaml)
        ds = M.YOLODataset(d[split], imgsz=64, augment=augment, hyp=dict(DEFAULT_CFG_DICT), max_gt=16)
        kw = dict(workers=workers) if M is P else {}
        out.append(M.DataLoader(ds, 4, shuffle=shuffle, seed=3, mosaic=mosaic, drop_last=drop_last, rect=rect, **kw))
    return out


def _epochs(loader, epochs=2):
    out = []
    for e in range(epochs):
        loader.set_epoch(e)
        out += list(loader)
    return out


@pytest.mark.parametrize("drop_last,rect,shuffle", [(True, False, True), (False, False, False), (False, True, False)],
                         ids=["train-order", "val-tail", "val-rect"])
def test_batches_without_augmentation_are_byte_identical(dataset, drop_last, rect, shuffle):
    """Square canvases at the training size: every array byte-identical. Rect canvases (32 x 64
    at imgsz 64) resize most frames, so there the labels are exact and the pixels held to the
    resize's own tolerance (within 1 grey level on 99 % of bytes)."""
    jl, pl = _loaders(dataset, augment=False, mosaic=False, drop_last=drop_last, rect=rect, shuffle=shuffle)
    jb, pb = _epochs(jl), _epochs(pl)
    assert len(jb) == len(pb) > 0
    for a, b in zip(jb, pb):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k == "img" and rect:
                d = np.abs(a[k].astype(np.int64) - b[k].astype(np.int64))
                assert np.mean(d <= 1) >= 0.99
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mosaic", [True, False], ids=["mosaic", "no-mosaic"])
def test_augmented_batches_labels_exact_pixels_close(dataset, mosaic):
    jl, pl = _loaders(dataset, augment=True, mosaic=mosaic)
    jb, pb = _epochs(jl), _epochs(pl)
    assert len(jb) == len(pb) == 6
    for a, b in zip(jb, pb):
        for k in ("cls", "bboxes", "mask"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        d = np.abs(a["img"].astype(np.int64) - b["img"].astype(np.int64))
        assert a["img"].shape == b["img"].shape and d.mean() <= 0.5 and np.mean(d == 0) >= 0.95


def test_val_loader_im_idx_is_exact(dataset):
    jl, pl = _loaders(dataset, augment=False, mosaic=False, drop_last=False, shuffle=False)
    jb, pb = _epochs(jl, 1), _epochs(pl, 1)
    assert [b["im_idx"].tolist() for b in jb] == [b["im_idx"].tolist() for b in pb]
    assert pb[-1]["im_idx"].min() == -1


def test_two_workers_give_the_batches_of_none(dataset):
    _, none = _loaders(dataset, augment=True, mosaic=True)
    _, two = _loaders(dataset, augment=True, mosaic=True, workers=2)
    try:
        assert two.workers == 2
        for a, b in zip(_epochs(none), _epochs(two)):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        two.close()


def test_label_cache_is_shared_by_both_packages(tmp_path):
    import bsyolo_tpu.data as J

    import bsyolo_tpu_torch.data as P

    yaml = write_dataset(tmp_path / "ds", n_train=4, n_val=1)
    images = str(yaml.parent / "images" / "train")
    for writer, reader in ((J, P), (P, J)):
        shutil.rmtree(yaml.parent / "labels" / "train.cache.npz", ignore_errors=True)
        (yaml.parent / "labels" / "train.cache.npz").unlink(missing_ok=True)
        w = writer.YOLODataset(images, imgsz=64, augment=False)
        assert (yaml.parent / "labels" / "train.cache.npz").exists()
        r = reader.YOLODataset(images, imgsz=64, augment=False)
        assert r._load_cache()  # the other package's file, hash and format accepted
        for (wc, wb), (rc, rb) in zip(w.labels, r.labels):
            np.testing.assert_array_equal(wc, rc)
            np.testing.assert_array_equal(wb, rb)


def test_bundled_dataset_yaml_resolves_against_datasets_dir(tmp_path, monkeypatch):
    from bsyolo_tpu_torch.data import load_dataset_yaml
    from bsyolo_tpu_torch.utils import settings

    f = tmp_path / "settings.json"
    f.write_text('{"datasets_dir": "%s"}' % (tmp_path / "sets"))
    monkeypatch.setattr(settings, "settings_file", lambda: f)
    d = load_dataset_yaml("car.yaml")
    assert d["path"] == tmp_path / "sets" / "car" and d["nc"] == 12 and d["names"][11] == "xiaofang"
    assert d["train"] == str(tmp_path / "sets" / "car" / "images" / "train")
