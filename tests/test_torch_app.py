"""The port's parking-violation application (``bsyolo_tpu_torch/app``) against the JAX package's.

- ``GRFBUNet`` carries the JAX variables across (``grfb_unet_state_dict_from_jax``)
  and its logits agree within 1e-4 of their largest magnitude at base_c 8, on
  64 x 96 and on 35 x 63, an odd size whose pools floor and whose skips pad.
- ``BlindwaySegmenter`` masks equal the JAX segmenter's, pixel for pixel: the
  port resizes with OpenCV's own 8-bit INTER_LINEAR arithmetic
  (``ops/resize.py``, held byte-equal to ``cv2.resize`` here), so both networks
  see the same input and the mask comes back through the same rounding; the
  logits then differ by float rounding only, which no argmax of these inputs
  turns into another class.
- The rule, the timer, the pipeline on ``tests/test_app.py``'s stub scene
  (events, annotated frames and written JPEGs byte for byte), a short clip
  through the real tiny detector and a small segmenter on converted weights
  (the same events, scores within rtol 1e-5, the annotated frames equal), and ``extract_static_background`` (the same frame).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import torch

from torch_port import nchw, port_module_from_jax, random_variables, to_plain_dict, variable_shapes

TINY = str(Path(__file__).parent / "fixtures" / "tiny.yaml")


def grfb_variables(base_c: int = 8, seed: int = 0, fg_bias: float = 0.0):
    """Seeded JAX GRFB-UNet variables (tests/torch_port.py draws); ``fg_bias`` is added to the
    second class's output bias, to balance the masks of random weights."""
    from bsyolo_tpu.app.grfb_unet import GRFBUNet

    v = to_plain_dict(random_variables(variable_shapes(GRFBUNet(num_classes=2, base_c=base_c), (1, 32, 32, 3)), seed))
    v["params"]["out_conv"]["bias"] = v["params"]["out_conv"]["bias"] + np.float32([0, fg_bias])
    return v


def segmenters(variables, base_c: int = 8, resize: int = 64):
    from bsyolo_tpu.app.grfb_unet import BlindwaySegmenter as JaxSegmenter
    from bsyolo_tpu_torch.app import BlindwaySegmenter
    from bsyolo_tpu_torch.utils.weights import grfb_unet_state_dict_from_jax

    return (BlindwaySegmenter(grfb_unet_state_dict_from_jax(variables), base_c=base_c, resize=resize, device="cpu"),
            JaxSegmenter(variables=variables, base_c=base_c, resize=resize))


def smooth_frame(rng, h, w):
    """A frame of large soft colour blobs, so masks come in regions and not in salt."""
    import cv2

    return cv2.resize(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8), (w, h), interpolation=cv2.INTER_CUBIC)


@pytest.mark.parametrize("hw", [(64, 96), (35, 63)])
def test_grfb_unet_forward_matches_jax(hw):
    import jax

    from bsyolo_tpu.app.grfb_unet import GRFBUNet as JaxNet
    from bsyolo_tpu_torch.app import GRFBUNet
    from bsyolo_tpu_torch.utils.weights import grfb_unet_state_dict_from_jax

    variables = grfb_variables()
    x = np.random.default_rng(1).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: JaxNet(num_classes=2, base_c=8).apply(v, x, train=False))(variables, x))
    net = GRFBUNet(num_classes=2, base_c=8)
    net.load_state_dict(grfb_unet_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(nchw(x))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, *hw, 2)
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"GRFB-UNet {hw}: max |diff| / max |logit| = {err:.2e}")
    assert err < 1e-4


@pytest.mark.parametrize("src,dst", [((720, 1280), (560, 1008)), ((96, 128), (64, 80)), ((35, 63), (48, 77)),
                                     ((64, 80), (96, 128)), ((120, 160), (60, 80)), ((7, 9), (13, 5))])
def test_resize_linear_u8_equals_opencv(src, dst):
    import cv2

    from bsyolo_tpu_torch.ops.resize import resize_linear_u8

    rng = np.random.default_rng(src[0])
    for img in (rng.integers(0, 256, (*src, 3), dtype=np.uint8), rng.integers(0, 2, src, dtype=np.uint8)):
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        t = torch.from_numpy(img)
        got = resize_linear_u8(t.permute(2, 0, 1) if img.ndim == 3 else t, dst)
        np.testing.assert_array_equal(got.permute(1, 2, 0).numpy() if img.ndim == 3 else got.numpy(), want)


def test_segmenter_masks_equal_jax():
    port, jax_seg = segmenters(grfb_variables(fg_bias=0.6))
    rng = np.random.default_rng(2)
    shares = []
    for h, w in ((96, 128), (75, 100), (64, 64)):
        frame = smooth_frame(rng, h, w)
        got, want = port(frame), jax_seg(frame)
        assert got.shape == want.shape == (h, w) and got.dtype == np.uint8
        assert set(np.unique(got)) <= {0, 255}
        np.testing.assert_array_equal(got, want)
        shares.append((got > 0).mean())
    print(f"mask foreground shares {np.round(shares, 3)}")
    assert all(0.05 < s < 0.95 for s in shares)


def test_violation_rule_and_timer_match_jax():
    from bsyolo_tpu.app import violation as jv
    from bsyolo_tpu_torch.app import violation as pv

    rng = np.random.default_rng(3)
    bg = np.zeros((80, 100), np.uint8)
    bg[30:50] = 255
    for _ in range(50):
        live = np.where(rng.random((80, 100)) < rng.random(), 255, 0).astype(np.uint8)
        xywh = (*rng.uniform(-10, 110, 2), *rng.uniform(0, 60, 2))
        x1, y1 = int(xywh[0] - xywh[2] / 2), int(xywh[1] - xywh[3] / 2)
        box = (x1, y1, int(xywh[0] + xywh[2] / 2), int(xywh[1] + xywh[3] / 2))
        assert pv.occlusion_ratio(box, live, bg) == jv.occlusion_ratio(box, live, bg)
        for thr in (0.3, 0.7):
            assert pv.is_parking_violation(xywh, live, bg, thr) == jv.is_parking_violation(xywh, live, bg, thr)
    t = [0.0]
    timers = [m.VehicleTimer(violation_threshold=5.0, iou_threshold=0.7, clock=lambda: t[0]) for m in (pv, jv)]
    flags = []
    for i in range(40):
        t[0] = i * 0.5
        tid = int(rng.integers(1, 4))
        shift = int(rng.integers(0, 3)) * 20 if i % 9 == 0 else 0
        box = (10 + shift, 10, 50 + shift, 40)
        if i % 13 == 12:
            for timer in timers:
                timer.reset(tid)
        got, want = (timer.update(tid, box) for timer in timers)
        assert got == want
        flags.append(got[1])
    assert any(flags) and not all(flags)


def _stub_pipelines():
    """tests/test_app.py's scene in both packages: a stub segmenter (yellow pixels are paving) and a
    stub detector that reports the car's box with track id 1."""
    from bsyolo_tpu.app import ParkingViolationPipeline as JaxPipeline
    from bsyolo_tpu.engine.results import Results as JaxResults
    from bsyolo_tpu_torch.app import ParkingViolationPipeline
    from bsyolo_tpu_torch.engine.results import Results

    def segment(frame):
        yellow = (frame[..., 2] > 180) & (frame[..., 1] > 180) & (frame[..., 0] < 120)
        return yellow.astype(np.uint8) * 255

    def detector(results_cls):
        class StubDetector:
            names = {0: "car"}

            def track(self, frame, **kw):
                boxes = np.asarray([[75.0, 85.0, 125.0, 130.0, 1.0, 0.9, 0.0]], np.float32)
                if frame[100, 10, 0] > 150:  # a second car, on the left, off the strip's middle
                    boxes = np.concatenate([boxes, [[2.0, 80.0, 48.0, 128.0, 2.0, 0.6, 0.0]]]).astype(np.float32)
                return [results_cls(frame, "frame", self.names, boxes=boxes)]

        return StubDetector()

    t = [0.0]
    kw = dict(occlusion_threshold=0.7, dwell_seconds=5.0, conf=0.00001, clock=lambda: t[0])
    return ParkingViolationPipeline(detector(Results), segment, **kw), JaxPipeline(detector(JaxResults), segment,
                                                                                    **kw), t


def _scene(car_x=None, left_car=False, size=200):
    img = np.full((size, size, 3), 60, np.uint8)
    img[90:120, :] = [40, 220, 230]  # yellow paving strip (BGR)
    if car_x is not None:
        img[85:130, car_x: car_x + 50] = [200, 190, 185]
    if left_car:
        img[80:128, 2:48] = [190, 180, 170]
    return img


def test_pipeline_on_the_stub_scene_matches_jax(tmp_path):
    port, jax_pipe, t = _stub_pipelines()
    for p in (port, jax_pipe):
        p.prepare_background(_scene())
    np.testing.assert_array_equal(port.background_mask, jax_pipe.background_mask)
    for i in range(8):
        t[0] = i * 2.0
        frame = _scene(car_x=75, left_car=3 <= i <= 5)
        out = {}
        for name, p in (("port", port), ("jax", jax_pipe)):
            (tmp_path / name).mkdir(exist_ok=True)
            out[name] = p.process_frame(frame, frame_idx=i, out_dir=tmp_path / name)
        got, want = out["port"], out["jax"]
        np.testing.assert_array_equal(got.pop("annotated"), want.pop("annotated"))
        assert got == want
    files = sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert "longtimeviolation_car_1.jpg" in files and "violation_frame_7.jpg" in files
    assert sorted(f.name for f in (tmp_path / "port").iterdir()) == files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def test_decide_and_render_split_process_frame():
    port, _, t = _stub_pipelines()
    port.prepare_background(_scene())
    frame = _scene(car_x=75)
    event, marks = port.decide(frame, frame_idx=0)
    assert [m.tid for m in marks] == [1] and marks[0].violating and event["violations"][0]["id"] == 1
    annotated = port.render(frame, 0, event, marks)
    assert annotated.shape == frame.shape and not np.array_equal(annotated, frame)
    assert np.array_equal(port.render(frame, 1, {"violations": []}, []), frame)


def clip_frames(n: int = 6, size: int = 64):
    """A 64 x 64 road with a yellow strip; a grey car drives in and stops across the strip."""
    frames = []
    for i in range(n):
        img = np.full((size, size, 3), 70, np.uint8)
        img[26:38] = (40, 210, 225)
        x = min(4 + 6 * i, 22)
        img[20:44, x: x + 20] = (190, 185, 180)
        frames.append(img)
    return frames


def test_pipeline_with_the_tiny_detector_and_a_small_segmenter_matches_jax():
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu.app import ParkingViolationPipeline as JaxPipeline
    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.app import ParkingViolationPipeline

    jm = JaxYOLO(TINY)
    variables = to_plain_dict(random_variables(variable_shapes(jm.model, (1, 64, 64, 3)), seed=4))
    jm.variables = {k: {**v} for k, v in variables.items()}
    pm = YOLO(TINY, device="cpu")
    port_module_from_jax(pm.model, variables)
    port_seg, jax_seg = segmenters(grfb_variables(fg_bias=0.6), resize=48)

    class Agnostic:
        """The facade, with class-agnostic NMS: random weights give each box once per class at
        near-equal scores, duplicates the tracker's matching would choose between by rounding."""

        def __init__(self, m):
            self.m, self.names = m, m.names

        def track(self, frame, **kw):
            return self.m.track(frame, imgsz=64, agnostic_nms=True, **kw)

    frames = clip_frames()
    events = {}
    for name, pipe_cls, m, seg in (("port", ParkingViolationPipeline, pm, port_seg),
                                   ("jax", JaxPipeline, jm, jax_seg)):
        idx = [0]
        # random weights box the whole frame, where the car hides 0.2 % of the paving mask: a low threshold
        # and a 0.1 s dwell at 25 fps make the rule and the timer fire within the clip
        pipe = pipe_cls(Agnostic(m), seg, dwell_seconds=0.1, occlusion_threshold=0.001, clock=lambda: idx[0] / 25)
        pipe.prepare_background(frames[0])
        events[name] = []
        for i, f in enumerate(frames):
            idx[0] = i
            events[name].append(pipe.process_frame(f, frame_idx=i))
    for got, want in zip(events["port"], events["jax"]):
        np.testing.assert_array_equal(got.pop("annotated"), want.pop("annotated"))
        # scores agree to float rounding (rtol 1e-5, as tests/test_torch_track.py holds them); all else exactly
        np.testing.assert_allclose([t.pop("conf") for t in got["tracks"]], [t.pop("conf") for t in want["tracks"]],
                                   rtol=1e-5, atol=0)
        assert got == want
    assert sum(len(e["tracks"]) for e in events["port"]) >= 10
    assert any(v["long"] for e in events["port"] for v in e["violations"])


def test_extract_static_background_matches_jax(tmp_path):
    import cv2

    from bsyolo_tpu.app import extract_static_background as jax_extract
    from bsyolo_tpu_torch.app import extract_static_background

    path = str(tmp_path / "bg.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    rng = np.random.default_rng(5)
    base = smooth_frame(rng, 64, 96)
    for i in range(12):
        f = base.copy()
        if i < 6:  # a car crossing, then a still scene
            f[20:40, 10 * i: 10 * i + 25] = 230
        vw.write(f)
    vw.release()
    got = extract_static_background(path, output_path=str(tmp_path / "port.png"))
    want = jax_extract(path, output_path=str(tmp_path / "jax.png"))
    assert got is not None and got.shape == (64, 96, 3)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
