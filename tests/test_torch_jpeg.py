"""The port's JPEG codec (``kernels/csrc/jpeg.cpp`` through ``data/jpeg.py``) against OpenCV.

The referee is ``cv2.imread(path)`` and ``cv2.imencode(".jpg", ...)`` of this
environment's OpenCV 5.0 (libjpeg-turbo 3.1). The decoder must give the same
array, byte for byte, on the bundled photos; on a matrix of files cv2 writes
here (sizes 1x1 to 480x640, quality 50 to 100, sampling 4:4:4, 4:2:2, 4:2:0,
4:4:0 and 4:1:1 and grey, baseline and progressive, restart intervals 0, 1
and 7); on a photo carrying each of the eight Exif orientations; and on cut
files. The encoder must give cv2's bytes at quality 75 and 95. Refused kinds
raise ``ImageFormatError`` naming what they are. The digests ``chip_smoke.py``
holds the card machine's build to are recomputed here with cv2.
"""

import hashlib
import importlib.util
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from bsyolo_tpu_torch.data.imread import ImageFormatError, decoded_size, image_size, imdecode, imread, imwrite  # noqa: E402
from bsyolo_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg, jpeg_info  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PHOTO_DIR = ROOT / "tests" / "fixtures" / "bsyolo8" / "images" / "train"
PHOTOS = sorted(PHOTO_DIR.glob("*.jpg"))
SIZES = [(1, 1), (7, 9), (17, 33), (321, 479), (480, 640)]
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111, "411": 0x411111}


def scene(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A photo resized to (h, w) with seeded noise on it: real structure and hard edges."""
    base = cv2.imread(str(PHOTOS[0]))
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_AREA)
    noise = np.random.default_rng(seed).integers(-24, 25, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def assert_decodes_like_cv2(data: bytes, path: Path):
    path.write_bytes(data)
    want = cv2.imread(str(path))
    got = decode_jpeg(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want), f"{int((got != want).sum())} bytes differ, max {np.abs(got.astype(int) - want).max()}"
    assert jpeg_info(data)[:2] == want.shape[:2]


@pytest.mark.parametrize("photo", PHOTOS, ids=[p.name for p in PHOTOS])
def test_bundled_photos_decode_like_cv2(photo):
    want = cv2.imread(str(photo))
    np.testing.assert_array_equal(imread(photo), want)
    assert jpeg_info(photo.read_bytes()) == (*want.shape[:2], 3)
    assert image_size(photo) == decoded_size(photo) == want.shape[:2]


@pytest.mark.parametrize("sampling", [*SAMPLING, "grey"])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_cv2_encoded_matrix_decodes_like_cv2(tmp_path, hw, sampling):
    """Every quality, progressive on and off and restart interval 0, 1 and 7 for one size and sampling."""
    img = scene(*hw, seed=hw[0])
    if sampling == "grey":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    for q in (50, 75, 95, 100):
        for progressive in (0, 1):
            for rst in (0, 1, 7):
                params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
                if sampling != "grey":
                    params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
                ok, data = cv2.imencode(".jpg", img, params)
                assert ok
                assert_decodes_like_cv2(data.tobytes(), tmp_path / f"q{q}p{progressive}r{rst}.jpg")
    assert jpeg_info(data.tobytes())[2] == (1 if sampling == "grey" else 3)


def exif_app1(orientation: int, little_endian: bool) -> bytes:
    """An APP1 Exif segment whose IFD0 holds one Orientation entry."""
    e = "<" if little_endian else ">"
    tiff = (b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
    tiff += struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applied_like_cv2(tmp_path, orientation):
    data = PHOTOS[1].read_bytes()
    for le in (True, False):
        rotated = data[:2] + exif_app1(orientation, le) + data[2:]
        assert_decodes_like_cv2(rotated, tmp_path / f"o{orientation}{le}.jpg")
    f = tmp_path / "r.jpg"
    f.write_bytes(rotated)
    h, w = cv2.imread(str(PHOTOS[1])).shape[:2]
    assert image_size(f) == (h, w)  # the stored size, as PIL reports it
    assert decoded_size(f) == ((w, h) if orientation >= 5 else (h, w))


def assert_cut_decodes_like_cv2(data: bytes, path: Path):
    """A cut file: the same array as cv2, or refused where cv2 refuses it (a cut inside a marker segment)."""
    path.write_bytes(data)
    if cv2.imread(str(path)) is None:
        with pytest.raises(ImageFormatError):
            decode_jpeg(data)
    else:
        assert_decodes_like_cv2(data, path)


@pytest.mark.parametrize("cut", [0.31, 0.5, 0.77, 0.999])
def test_truncated_file_decodes_like_cv2(tmp_path, cut):
    """A file cut mid-scan: libjpeg-turbo reads zero bits past the end and leaves the MCUs after the
    one the data ran out in at zero (mid-grey); with restart markers too; a progressive file cut before
    its last scans also gets libjpeg's block smoothing of the coefficients that did not all arrive."""
    data = PHOTOS[2].read_bytes()
    assert_decodes_like_cv2(data[: int(len(data) * cut)], tmp_path / "cut.jpg")
    img = scene(100, 130, 5)
    for params in ([cv2.IMWRITE_JPEG_RST_INTERVAL, 3], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                   [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2]):
        full = cv2.imencode(".jpg", img, params)[1].tobytes()
        assert_cut_decodes_like_cv2(full[: int(len(full) * cut)], tmp_path / "cut2.jpg")
    prog = cv2.imencode(".jpg", cv2.imread(str(PHOTOS[2])), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    assert_cut_decodes_like_cv2(prog[: int(len(prog) * cut)], tmp_path / "cut3.jpg")


@pytest.mark.parametrize("sampling", ["420", "422", "411", "grey"])
def test_progressive_file_cut_anywhere_decodes_like_cv2(tmp_path, sampling):
    """Cuts every few bytes through a small progressive file, inside scans and inside the marker segments
    between them (where libjpeg reads on into the fake EOI of its file source)."""
    img = scene(40, 57, 9)
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 80]
    if sampling == "grey":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    full = cv2.imencode(".jpg", img, params)[1].tobytes()
    for n in range(160, len(full), 11):
        assert_cut_decodes_like_cv2(full[:n], tmp_path / f"c{n}.jpg")


def _patch_sof(data: bytes, marker: int = None, precision: int = None, ncomp: int = None) -> bytes:
    i = data.index(b"\xff\xc0")
    b = bytearray(data)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    if ncomp is not None:
        b[i + 9] = ncomp
    return bytes(b)


@pytest.mark.parametrize("kind,patch,match", [
    ("arithmetic", dict(marker=0xC9), "arithmetic"),
    ("arithmetic progressive", dict(marker=0xCA), "arithmetic"),
    ("lossless", dict(marker=0xC3), "lossless"),
    ("hierarchical", dict(marker=0xC5), "hierarchical"),
    ("12-bit", dict(marker=0xC1, precision=12), "12-bit"),
    ("CMYK", dict(ncomp=4), "CMYK"),
])
def test_refused_kinds_raise_naming_what_they_are(kind, patch, match):
    data = _patch_sof(PHOTOS[0].read_bytes(), **patch)
    for call in (jpeg_info, decode_jpeg, imdecode):
        with pytest.raises(ImageFormatError, match=match) as e:
            call(data)
        assert "item 21" in str(e.value)


def test_corrupt_input_raises_format_error(tmp_path):
    data = PHOTOS[0].read_bytes()
    for bad in (b"", b"\xff\xd8", data[:100], b"\xff\xd8\xff\xd9", b"GIF89a" + data[6:]):
        with pytest.raises(ImageFormatError):
            imdecode(bad)
    (tmp_path / "bad.jpg").write_bytes(data[:120])
    with pytest.raises(ImageFormatError, match="bad.jpg"):
        imread(tmp_path / "bad.jpg")


@pytest.mark.parametrize("grey", [False, True], ids=["colour", "grey"])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("hw", [(1, 1), (17, 33), (240, 320), (427, 320)], ids=["1x1", "17x33", "240x320", "427x320"])
def test_encoder_is_byte_equal_to_cv2(tmp_path, hw, quality, grey):
    img = scene(*hw, seed=7)
    if grey:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
    assert encode_jpeg(img, quality) == want
    if quality == 95:  # imwrite's default quality is cv2.imwrite's
        imwrite(tmp_path / "a.jpg", img)
        cv2.imwrite(str(tmp_path / "b.jpg"), img)
        assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()


def test_chip_smoke_digests_are_cv2s():
    """``chip_smoke.py`` holds the card machine's codec to these digests: each is OpenCV's."""
    spec = importlib.util.spec_from_file_location("chip_smoke_digests", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert sorted(smoke.PHOTO_DIGESTS) == [p.name for p in PHOTOS]
    for p in PHOTOS:
        h, w, px, jpg = smoke.PHOTO_DIGESTS[p.name]
        img = cv2.imread(str(p))
        assert img.shape == (h, w, 3)
        assert hashlib.sha256(img.tobytes()).hexdigest() == px
        assert hashlib.sha256(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()).hexdigest() == jpg


def test_decoding_threads_run_in_parallel_and_agree():
    """ctypes releases the GIL for each call: eight threads decode the photos at once, each result equal
    to cv2's."""
    datas = [p.read_bytes() for p in PHOTOS] * 4
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(decode_jpeg, datas))
    for p, g in zip(PHOTOS * 4, got):
        np.testing.assert_array_equal(g, cv2.imread(str(p)))


def test_a_built_codec_loads_without_a_compiler(monkeypatch):
    """The library is named by its source and flags: a process that finds it built loads it and runs no
    compiler, so a machine without one on PATH decodes with it."""
    from bsyolo_tpu_torch.kernels import build

    build.load_library("jpeg")  # built once, here or by an earlier test

    def no_compiler(*args, **kwargs):
        raise AssertionError("a compiler was asked for")

    monkeypatch.setattr(build, "cxx", no_compiler)
    monkeypatch.setattr(build.subprocess, "run", no_compiler)
    monkeypatch.setattr(build.subprocess, "Popen", no_compiler)
    monkeypatch.setattr(build, "_libs", {})
    lib = build.load_library("jpeg")
    assert lib is not None and build._target("jpeg").exists()
    np.testing.assert_array_equal(decode_jpeg(PHOTOS[0].read_bytes()), cv2.imread(str(PHOTOS[0])))
