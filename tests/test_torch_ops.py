"""Ops of the PyTorch port (bsyolo_tpu_torch.ops, cfg, nn.parser) against bsyolo_tpu.

Box and anchor ops agree to float32 rounding (rtol 1e-6, atol 1e-5 px);
letterbox_params is exact; the torch letterbox of a uint8 frame is byte-equal
to the OpenCV one (the bundled photos, up- and down-scaled); the YAML reader
returns exactly what yaml.safe_load returns.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax.numpy as jnp
import torch

REPO = Path(__file__).resolve().parents[1]
PHOTOS = sorted((REPO / "tests/fixtures/bsyolo8/images/train").glob("*.jpg"))


def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(1, 80, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["xywh2xyxy", "xyxy2xywh", "clip_boxes", "scale_boxes", "scale_boxes_ratio_pad",
                                "box_iou_pairwise"])
def test_box_ops_match_jax(rng, fn):
    from bsyolo_tpu.ops import boxes as J
    from bsyolo_tpu_torch.ops import boxes as P

    a, b = _boxes(rng, 37), _boxes(rng, 23)
    calls = {
        "xywh2xyxy": lambda m, x, y: m.xywh2xyxy(x),
        "xyxy2xywh": lambda m, x, y: m.xyxy2xywh(x),
        "clip_boxes": lambda m, x, y: m.clip_boxes(x, (120, 150)),
        "scale_boxes": lambda m, x, y: m.scale_boxes((256, 256), x, (180, 240)),
        "scale_boxes_ratio_pad": lambda m, x, y: m.scale_boxes((256, 256), x, (200, 250), ratio_pad=((0.9,), (3, 7))),
        "box_iou_pairwise": lambda m, x, y: m.box_iou_pairwise(x, y),
    }
    got = calls[fn](P, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(calls[fn](J, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_pairwise_iou_is_batched(rng):
    from bsyolo_tpu.ops.boxes import box_iou_pairwise as jiou
    from bsyolo_tpu_torch.ops.boxes import box_iou_pairwise

    a = np.stack([_boxes(rng, 11), _boxes(rng, 11)])
    got = box_iou_pairwise(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    for i in range(2):
        np.testing.assert_allclose(got[i], np.asarray(jiou(jnp.asarray(a[i]), jnp.asarray(a[i]))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("xywh", [True, False])
def test_anchors_and_dist2bbox_match_jax(rng, xywh):
    from bsyolo_tpu.ops.anchors import dist2bbox as jd2b, make_anchors as jmake
    from bsyolo_tpu_torch.ops.anchors import dist2bbox, make_anchors

    shapes, strides = [(8, 10), (4, 5), (2, 3)], (8, 16, 32)
    pts, st = make_anchors(shapes, strides)
    jpts, jst = jmake(shapes, strides)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    dist = rng.uniform(0, 15, (2, len(pts), 4)).astype(np.float32)
    got = dist2bbox(torch.from_numpy(dist), pts[None], xywh=xywh).numpy()
    np.testing.assert_allclose(got, np.asarray(jd2b(jnp.asarray(dist), jpts[None], xywh=xywh)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "shape,new_shape,kw",
    [((427, 320), (640, 640), {}), ((480, 640), (640, 640), {}), ((720, 1280), (640, 640), {}),
     ((331, 320), (128, 128), {}), ((97, 131), (64, 96), {"scaleup": False}), ((500, 375), (320, 320), {"auto": True}),
     ((500, 375), (320, 320), {"scale_fill": True}), ((233, 611), (256, 256), {"center": False})],
)
def test_letterbox_params_exact(shape, new_shape, kw):
    from bsyolo_tpu.ops.letterbox import letterbox_params as jparams
    from bsyolo_tpu_torch.ops.letterbox import letterbox_params

    assert letterbox_params(shape, new_shape, **kw) == jparams(shape, new_shape, **kw)


@pytest.mark.parametrize("imgsz", [128, 640])
@pytest.mark.parametrize("photo", [0, 4])
def test_letterbox_matches_opencv(photo, imgsz):
    """Down-scaled (128) and up-scaled (640) photos: byte-equal to the OpenCV letterbox."""
    import cv2

    from bsyolo_tpu.ops.letterbox import letterbox_image
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    im = cv2.imread(str(PHOTOS[photo]))
    want = np.ascontiguousarray(letterbox_image(im, (imgsz, imgsz))[0][..., ::-1].transpose(2, 0, 1))
    got = letterbox(im, (imgsz, imgsz), "cpu")
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(96, 128), (128, 128), (128, 77)])
def test_letterbox_without_resize_is_exact(rng, hw):
    from bsyolo_tpu.ops.letterbox import letterbox_image
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    im = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = letterbox_image(im, (128, 128))[0][..., ::-1].transpose(2, 0, 1)
    np.testing.assert_array_equal(letterbox(im, (128, 128), "cpu").numpy(), want)


@pytest.mark.parametrize("name", ["yolo11.yaml", "yolo11old.yaml"])
def test_yaml_reader_on_the_port_copies(name):
    import yaml

    from bsyolo_tpu_torch.cfg import CFG_ROOT, read_yaml

    path = CFG_ROOT / "models" / "11" / name
    assert path.read_text() == (REPO / "bsyolo_tpu/cfg/models/11" / name).read_text()
    got, want = read_yaml(path), yaml.safe_load(path.read_text())
    assert got == want and repr(got) == repr(want)


def test_yaml_reader_on_the_jax_model_zoo():
    """Every model YAML of the JAX package reads as yaml.safe_load reads it (types included)."""
    import yaml

    from bsyolo_tpu_torch.cfg import read_yaml

    paths = sorted((REPO / "bsyolo_tpu/cfg/models").glob("**/*.yaml"))
    assert len(paths) > 40
    for p in paths:
        got, want = read_yaml(p), yaml.safe_load(p.read_text())
        assert repr(got) == repr(want), p


@pytest.mark.parametrize(
    "text",
    ["a: &x 1\nb: *x\n", "a: [1,\n  2]\n", "a:\n  - b: 1\n", "a: {b: 1}\n", "a: |\n  text\n", "a: 0x1F\n",
     "a: 2001-12-14\n", "---\na: 1\n"],
)
def test_yaml_reader_refuses_what_it_does_not_support(text):
    from bsyolo_tpu_torch.cfg import YamlSubsetError, load_yaml

    with pytest.raises(YamlSubsetError):
        load_yaml(text)


def test_yaml_scalars_resolve_as_pyyaml():
    import yaml

    from bsyolo_tpu_torch.cfg import load_yaml

    text = ("a: [None, null, ~, True, yes, off, 1, -2, 0.5, 1., .5, 1e-3, 1.0e-3, +7, 'x # y', \"q\", nn.ReLU()]\n"
            "b:\n- [1, [2, 3], []]\nc: # empty\nd: 'it''s'  # comment\n")
    got, want = load_yaml(text), yaml.safe_load(text)
    assert repr(got) == repr(want)


def test_model_yaml_path_and_scale_from_name():
    from bsyolo_tpu_torch.cfg import model_yaml_path
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    p = model_yaml_path("yolo11s.yaml")
    assert p.name == "yolo11s.yaml" and p.parent.name == "11"
    d = load_model_yaml(p)
    assert d["scale"] == "s" and parse_model_yaml(d).scale == "s"
    assert parse_model_yaml(load_model_yaml(model_yaml_path("yolo11old.yaml"))).nc == 80
    with pytest.raises(FileNotFoundError):
        model_yaml_path("yolov99z.yaml")


def test_parser_matches_jax_and_names_unknown_modules():
    from bsyolo_tpu_torch.nn.parser import parse_model_yaml
    from torch_port import jax_spec, port_spec

    for name in ("yolo11n.yaml", "yolo11old.yaml"):
        j, p = jax_spec(name), port_spec(name)
        # the head args end with the legacy flag in both parsers
        assert [(l.i, l.f, l.n, l.args, l.c1, l.c2, l.stride) for l in p.layers] == [
            (l.i, l.f, l.n, l.args, l.c1, l.c2, l.stride) for l in j.layers
        ]
        assert (p.save, p.nc, p.head_strides, p.names) == (j.save, j.nc, j.head_strides, j.names)
    d = {"nc": 2, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "RepC3", [16]]], "head": []}
    with pytest.raises(NotImplementedError, match="RepC3"):
        parse_model_yaml(d)
