"""Int8 inference on the Segment, Pose, OBB and Classify graphs (``nn.modules.set_int8_inference``,
``nn.quant.calibrate_int8``, ``utils.weights.scales_from_jax``; int8 predict and int8 ``val``, Detect's
``val`` too) against bsyolo_tpu with its int8 switch on, on the CPU, where the int8 products run the
kernel's plain version.

tests/fixtures/tiny{seg,pose,obb,cls}.yaml with seeded variables carried from JAX, each package
calibrated on the same two batches. Gates (tolerances as tests/test_torch_int8.py states them):
- the quantized convs are the JAX package's, Proto's three and Classify's one included: the same
  keys after ``scales_from_jax``, the scales within rtol 1e-5;
- the graph run free in static int8 with the JAX scales: head maps, prototypes and logits within
  ``GRAPH_RTOL`` of their scale in the median element, everywhere within twice the largest
  int8-against-float gap (a code that flips at a rounding boundary moves the codes after it), and
  int8 really ran (median gap at least 10 times ``GRAPH_RTOL``);
- int8 predict against the JAX predictor built after ``set_int8_inference(True, scales)``: rows with
  classes equal, scores within rtol 1e-5, boxes within 1e-3 px (angles 1e-5 rad), keypoints within
  1e-3 px, binarized masks equal in 0.999 of their pixels, Classify probabilities within 1e-6;
- int8 ``val`` of each of the five families, trained for 60 epochs in float32 on a set that is its
  own validation split (``torch_port.trained_task_checkpoint``): metrics within ``VAL_ATOL`` of the
  JAX facade's on the same checkpoint and scales (a Segment or Pose fitness, the sum of two
  fitnesses, within twice that).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from bsyolo_tpu.nn import modules as JM
from torch_port import nchw, task_models, trained_task_checkpoint

GRAPH_RTOL = 1e-5
VAL_ATOL = 0.02
IMG = 64
FIX = Path(__file__).parent / "fixtures"
TASKS = {"segment": "tinyseg.yaml", "pose": "tinypose.yaml", "obb": "tinyobb.yaml", "classify": "tinycls.yaml"}
N_CONVS = {"segment": 39, "pose": 36, "obb": 36, "classify": 19}  # Proto's cv1, cv2, cv3; Classify's conv


def _yaml(task):
    return str(FIX / (TASKS.get(task) or "tiny.yaml"))


@pytest.fixture(autouse=True)
def _reset_jax_mode():
    """The JAX mode is process-wide: leave it off after every test."""
    yield
    JM.set_int8_inference(False)
    JM.set_int8_calibration(False)


@pytest.fixture(scope="module")
def calibrated():
    """task -> the graph on both sides with the same weights, each calibrated by its own package on the
    same two batches: dict(jmodel, spec, variables, port (YOLO), batches, jax_scales, scales)."""
    from bsyolo_tpu.nn.quant import calibrate_int8 as jax_calibrate
    from bsyolo_tpu_torch.nn.quant import calibrate_int8

    out = {}
    for i, task in enumerate(TASKS):
        jmodel, spec, variables, port = task_models(_yaml(task), IMG, seed=60 + i)
        brng = np.random.default_rng(70 + i)
        batches = [brng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32) for _ in range(2)]
        out[task] = dict(jmodel=jmodel, spec=spec, variables=variables, port=port, batches=batches,
                         jax_scales=jax_calibrate(jmodel, variables, [jnp.asarray(b) for b in batches]),
                         scales=calibrate_int8(port.model, [torch.from_numpy(nchw(b)) for b in batches]))
    return out


@pytest.mark.parametrize("task", list(TASKS))
def test_calibration_matches_jax(task, calibrated):
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    c = calibrated[task]
    want, got = scales_from_jax(c["jax_scales"]), c["scales"]
    head = f"model.{len(c['spec'].layers) - 1}"
    own = ([f"{head}.proto.{k}.conv" for k in ("cv1", "cv2", "cv3")] if task == "segment"
           else [f"{head}.conv.conv"] if task == "classify" else [])
    print(f"{task}: {len(got)} quantized convs, {len(own)} of them the head's own")
    assert set(got) == set(want) and len(got) == N_CONVS[task] and set(own) <= set(got)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys], [want[k] for k in keys], rtol=1e-5)


def _flat(out):
    """A head's output -> its maps as NCHW-or-2D numpy arrays (torch) or NHWC-or-2D (JAX) in order."""
    if isinstance(out, dict):
        return [*out["feats"], out["proto"]]
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("task", list(TASKS))
def test_graph_int8_head_maps_match_jax(task, calibrated):
    from bsyolo_tpu_torch.nn.modules import set_int8_inference
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    c = calibrated[task]
    x = np.random.default_rng(80).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    JM.set_int8_inference(True, c["jax_scales"])
    try:
        want = jax.jit(lambda v, xx: c["jmodel"].apply(v, xx, train=False))(c["variables"], jnp.asarray(x))
    finally:
        JM.set_int8_inference(False)
    model, xt = c["port"].model, torch.from_numpy(nchw(x))
    with torch.no_grad():
        ref = model(xt)
        set_int8_inference(model, True, scales_from_jax(c["jax_scales"]))
        try:
            got = model(xt)
        finally:
            set_int8_inference(model, False)
    for g, w, f in zip(_flat(got), _flat(want), _flat(ref)):
        w = np.asarray(w)
        w = nchw(w) if w.ndim == 4 else w
        g, f = g.numpy(), f.numpy()
        scale = np.abs(w).max()
        diff, gap = np.abs(g - w), np.abs(g - f)
        print(f"{task} int8 output {g.shape}: median |port - JAX| {np.median(diff) / scale:.3g}, largest "
              f"{diff.max() / scale:.3g} of the scale; int8 against float median {np.median(gap) / scale:.3g}, "
              f"largest {gap.max() / scale:.3g}")
        assert np.median(gap) >= 10 * GRAPH_RTOL * scale  # int8 really ran
        assert np.median(diff) <= GRAPH_RTOL * scale and diff.max() <= 2 * gap.max()


@pytest.mark.parametrize("task", list(TASKS))
def test_int8_predict_matches_jax(task, calibrated):
    """YOLO.predict with int8 on (the JAX scales carried over) against the JAX DetectionPredictor built
    after set_int8_inference(True, scales), row by row; the same frames in float give other rows."""
    from bsyolo_tpu.engine.predictor import DetectionPredictor
    from bsyolo_tpu_torch.nn.modules import int8_inference, set_int8_inference
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    c = calibrated[task]
    port = c["port"]
    rng = np.random.default_rng(90)
    frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)]
    kw = dict(imgsz=IMG, conf=0.001, batch=2)
    f32 = port.predict(frames, **kw)
    JM.set_int8_inference(True, c["jax_scales"])
    want = DetectionPredictor(c["jmodel"], c["spec"], c["variables"], conf=0.001, imgsz=IMG, batch=2,
                              names=port.names)(frames)
    set_int8_inference(port.model, True, scales_from_jax(c["jax_scales"]))
    try:
        assert int8_inference(port.model)
        got = port.predict(frames, **kw)
    finally:
        set_int8_inference(port.model, False)
    for g, w, f in zip(got, want, f32):
        if task == "classify":
            np.testing.assert_allclose(g.probs.data, np.asarray(w.probs.data), rtol=0, atol=1e-6)
            assert np.abs(g.probs.data - f.probs.data).max() > 1e-6  # int8 changed the probabilities
            continue
        gd = g.obb.data if task == "obb" else g.boxes.data
        wd = np.asarray(w.obb.data if task == "obb" else w.boxes.data)
        fd = f.obb.data if task == "obb" else f.boxes.data
        print(f"int8 predict {task}: {len(gd)} rows (JAX {len(wd)})")
        assert gd.shape == wd.shape and len(gd) >= 3
        np.testing.assert_array_equal(gd[:, 5], wd[:, 5])
        np.testing.assert_allclose(gd[:, 4], wd[:, 4], rtol=1e-5, atol=0)
        np.testing.assert_allclose(gd[:, :4], wd[:, :4], rtol=0, atol=1e-3)
        if task == "obb":
            np.testing.assert_allclose(gd[:, 6], wd[:, 6], rtol=0, atol=1e-5)
        if task == "pose":
            np.testing.assert_allclose(g.keypoints.data[..., :2], np.asarray(w.keypoints.data)[..., :2], rtol=0,
                                       atol=1e-3)
        if task == "segment":
            wm = np.asarray(w.masks.data)
            assert g.masks.data.shape == wm.shape and (g.masks.data == wm).mean() >= 0.999
        assert gd.shape != fd.shape or np.abs(gd[:, 4] - fd[:, 4]).max() > 1e-4  # int8 changed the scores


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """task -> (best.ckpt of the tiny graph trained in float32 on a set that is its own val split, its
    data), trained on first use."""
    root, done = tmp_path_factory.mktemp("task_int8"), {}

    def get(task):
        if task not in done:
            done[task] = trained_task_checkpoint(root / task, task, _yaml(task), epochs=60)
        return done[task]

    return get


def _calibration_batches(data, task):
    """Two NHWC float batches of 4 of the set's images, letterboxed to IMG by the port."""
    from bsyolo_tpu_torch.data.imread import imread
    from bsyolo_tpu_torch.ops.letterbox import letterbox

    root = Path(data) / "train" if task == "classify" else Path(data).parent / "images" / "train"
    files = sorted(root.rglob("*.png"))[:8]
    x = np.stack([letterbox(imread(str(f)), (IMG, IMG), "cpu").numpy().transpose(1, 2, 0) for f in files])  # RGB
    return [np.ascontiguousarray(b, np.float32) / 255.0 for b in (x[:4], x[4:])]


@pytest.mark.parametrize("task", ["detect", *TASKS])
def test_int8_val_matches_jax(task, trained):
    """``YOLO(best.ckpt).val()`` with int8 on, each package calibrated on the same two batches of the
    validation images (letterboxed by the port, /255) and both running the JAX scales, against the JAX
    facade's val with its switch on."""
    from bsyolo_tpu import YOLO as JaxYOLO
    from bsyolo_tpu.engine.trainer import load_checkpoint as jax_load
    from bsyolo_tpu.nn.quant import calibrate_int8 as jax_calibrate
    from bsyolo_tpu_torch import YOLO
    from bsyolo_tpu_torch.nn.modules import set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    from bsyolo_tpu_torch.utils.weights import scales_from_jax

    best, data = trained(task)
    port = YOLO(best, device="cpu")
    jy = JaxYOLO(_yaml(task))
    payload, _ = jax_load(best)
    jy.variables = {"params": payload["ema_params"], "batch_stats": payload["batch_stats"]}
    f32 = port.val(data=str(data), batch=4, imgsz=IMG).results_dict
    batches = _calibration_batches(data, task)
    jax_scales = jax_calibrate(jy.model, jy.variables, [jnp.asarray(b) for b in batches])
    scales = calibrate_int8(port.model, [torch.from_numpy(nchw(b)) for b in batches])
    keys = sorted(scales)
    np.testing.assert_allclose([scales[k] for k in keys], [scales_from_jax(jax_scales)[k] for k in keys], rtol=1e-5)
    set_int8_inference(port.model, True, scales_from_jax(jax_scales))
    try:
        got = port.val(data=str(data), batch=4, imgsz=IMG).results_dict
    finally:
        set_int8_inference(port.model, False)
    JM.set_int8_inference(True, jax_scales)
    want = jy.val(data=str(data), batch=4, imgsz=IMG).results_dict
    main = "metrics/accuracy_top1" if task == "classify" else "metrics/mAP50(B)"
    print(f"int8 val {task}: port {got}; JAX {want}; port float32 {f32}")
    assert got.keys() == want.keys() and float(want[main]) > 0.5
    for k in want:  # a Segment or Pose fitness sums the box and the mask or keypoint fitness: twice the bound
        bound = 2 * VAL_ATOL if k == "fitness" and task in ("segment", "pose") else VAL_ATOL
        assert abs(float(got[k]) - float(want[k])) <= bound, k


@pytest.mark.slow
class TestInt8Accuracy:
    def test_trained_tiny_model_keeps_map(self, tmp_path):
        """The port's counterpart of tests/test_int8.py's TestInt8Accuracy: overfit tiny.yaml on the synthetic
        squares and circles (30 epochs at 96 px, float32; the original's 20 leave float32 mAP50 at 0.4975 in
        the port and 0.492 in JAX, under the 0.5 bar), then validate the EMA weights in float32 and in dynamic
        int8 (each conv's scale from its batch's abs-max): int8 costs at most 0.05 mAP50."""
        from test_e2e_train import make_synthetic_dataset

        from bsyolo_tpu_torch.data import DataLoader, YOLODataset, load_dataset_yaml
        from bsyolo_tpu_torch.engine.trainer import DetectionTrainer, val_batches
        from bsyolo_tpu_torch.engine.validator import DetectionValidator
        from bsyolo_tpu_torch.nn.modules import set_int8_inference

        data = make_synthetic_dataset(tmp_path / "ds")
        t = DetectionTrainer(overrides={
            "model": str(FIX / "tiny.yaml"), "data": str(data), "epochs": 30, "batch": 8, "imgsz": 96,
            "optimizer": "SGD", "lr0": 0.02, "warmup_epochs": 1.0, "close_mosaic": 8, "project": str(tmp_path / "runs"),
            "name": "t", "max_gt": 32, "amp": False, "nbs": 8, "device": "cpu", "workers": 0, "plots": False})
        t.train()
        d = load_dataset_yaml(str(data))
        loader = DataLoader(YOLODataset(d["val"], imgsz=96, augment=False, max_gt=32), 8, shuffle=False,
                            drop_last=False)
        validator = DetectionValidator(t.model, t.spec, device="cpu")
        map50_f32 = validator(t.state.ema_params, val_batches(loader, t.device)).box.map50
        set_int8_inference(t.model, True)
        try:
            map50_i8 = validator(t.state.ema_params, val_batches(loader, t.device)).box.map50
        finally:
            set_int8_inference(t.model, False)
        print(f"mAP50 float32 {map50_f32:.4f}, dynamic int8 {map50_i8:.4f}")
        assert map50_f32 > 0.5, f"training failed to converge: {map50_f32}"
        assert map50_i8 > map50_f32 - 0.05, (map50_f32, map50_i8)
