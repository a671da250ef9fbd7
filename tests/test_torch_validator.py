"""The port's detect validation (utils.metrics, engine.validator) against bsyolo_tpu.

Metrics on seeded predictions: ap_per_class, match_predictions,
DetMetrics.results_dict and ConfusionMatrix.matrix within rtol 1e-9 or
identical. The validator end to end: tests/fixtures/tiny.yaml with nc 3 at
imgsz 64, the same seeded weights on both sides, over the val batches the JAX
DataLoader makes of tests/fixtures/bsyolo8 (rect, shuffle off, batch 4: two
canvas shapes, 64x64 and 64x32, and rows that pad a shape's last batch),
fed to both; then with a forward_fn that returns the ground truths, jittered,
as predictions, so the mAP is not zero. Metrics equal within rtol 1e-6.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import torch

from torch_port import nchw, random_variables, to_plain_dict, variable_shapes

TINY = str(Path(__file__).parent / "fixtures" / "tiny.yaml")
IMAGES = str(Path(__file__).parent / "fixtures" / "bsyolo8" / "images" / "train")
NAMES = {0: "car", 1: "person", 2: "motorcycle"}


def _seeded_stats(seed, n=400, nc=5):
    rng = np.random.default_rng(seed)
    tp = rng.random((n, 10)) < np.linspace(0.7, 0.2, 10)
    tp[:, 1:] &= tp[:, :1]
    return tp, rng.random(n), rng.integers(0, nc, n).astype(float), rng.integers(0, nc, n // 2).astype(float)


def test_ap_per_class_matches_jax():
    from bsyolo_tpu.utils.metrics import ap_per_class as jap
    from bsyolo_tpu_torch.utils.metrics import ap_per_class

    for seed in (0, 1, 2):
        args = _seeded_stats(seed)
        for g, w in zip(ap_per_class(*args), jap(*args)):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0)


def test_match_predictions_and_confusion_matrix_match_jax():
    from bsyolo_tpu.utils.metrics import ConfusionMatrix as JCM, _box_iou_np as jiou, match_predictions as jmatch
    from bsyolo_tpu_torch.utils.metrics import ConfusionMatrix, _box_iou_np, match_predictions

    rng = np.random.default_rng(3)
    got_cm, want_cm = ConfusionMatrix(nc=4), JCM(nc=4)
    iouv = np.linspace(0.5, 0.95, 10)
    for i in range(12):
        gt = rng.uniform(0, 50, (6, 2))
        gt = np.concatenate([gt, gt + rng.uniform(5, 30, (6, 2))], 1)
        gt_cls = rng.integers(0, 4, 6).astype(float)
        det = gt[rng.integers(0, 6, 9)] + rng.normal(0, 3, (9, 4))
        dets = np.concatenate([det, rng.random((9, 1)), rng.integers(0, 4, (9, 1))], 1)
        if i == 5:
            gt, gt_cls = gt[:0], gt_cls[:0]  # an image without ground truth
        iou = _box_iou_np(gt, dets[:, :4])
        np.testing.assert_array_equal(iou, jiou(gt, dets[:, :4]))
        np.testing.assert_array_equal(match_predictions(dets[:, 5], gt_cls, iou, iouv),
                                      jmatch(dets[:, 5], gt_cls, iou, iouv))
        got_cm.process_batch(None if i == 7 else dets, gt, gt_cls)
        want_cm.process_batch(None if i == 7 else dets, gt, gt_cls)
    np.testing.assert_array_equal(got_cm.matrix, want_cm.matrix)
    assert got_cm.matrix.sum() > 0


def test_det_metrics_results_dict_matches_jax():
    from bsyolo_tpu.utils.metrics import DetMetrics as JDM
    from bsyolo_tpu_torch.utils.metrics import DetMetrics

    got, want = DetMetrics(names={i: str(i) for i in range(5)}), JDM(names={i: str(i) for i in range(5)})
    args = _seeded_stats(4)
    got.process(*args)
    want.process(*args)
    assert list(got.results_dict) == list(want.results_dict)
    np.testing.assert_allclose(list(got.results_dict.values()), list(want.results_dict.values()), rtol=1e-9)
    np.testing.assert_allclose(got.maps, want.maps, rtol=1e-9)


# --- the validator -----------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """JAX graph and seeded variables, the port graph with the same weights, and the JAX val batches."""
    from bsyolo_tpu.data.build import DataLoader
    from bsyolo_tpu.data.dataset import YOLODataset
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml
    from bsyolo_tpu.nn.model import DetectionGraph
    from bsyolo_tpu_torch.nn.model import DetectionGraph as PortGraph
    from bsyolo_tpu_torch.nn.parser import load_model_yaml as port_yaml, parse_model_yaml as port_parse
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    d = load_model_yaml(TINY)
    d["nc"] = 3
    spec = parse_model_yaml(d)
    jmodel = DetectionGraph(spec)
    variables = to_plain_dict(random_variables(variable_shapes(jmodel, (1, 64, 64, 3)), seed=8))
    pd = port_yaml(TINY)
    pd["nc"] = 3
    pspec = port_parse(pd)
    port = PortGraph(pspec)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    ds = YOLODataset(IMAGES, imgsz=64, augment=False, max_gt=8)
    batches = list(DataLoader(ds, batch_size=4, shuffle=False, drop_last=False, rect=True))
    assert {b["img"].shape[1:3] for b in batches} == {(64, 64), (64, 32)}
    assert any((b["im_idx"] < 0).any() for b in batches)
    return jmodel, spec, variables, port.eval(), pspec, batches


def _port_batches(batches):
    return [{**b, "img": nchw(b["img"])} for b in batches]


def _results(metrics):
    return np.array(list(metrics.results_dict.values()))


def test_validator_matches_jax(setup):
    from bsyolo_tpu.engine.validator import DetectionValidator as JV
    from bsyolo_tpu_torch.engine.validator import DetectionValidator

    jmodel, spec, variables, port, pspec, batches = setup
    want = JV(jmodel, spec, names=NAMES)(variables, batches, verbose=False)
    got = DetectionValidator(port, pspec, names=NAMES, device="cpu")(None, _port_batches(batches), verbose=False)
    np.testing.assert_allclose(_results(got), _results(want), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(got.confusion_matrix.matrix, want.confusion_matrix.matrix)
    assert got.confusion_matrix.matrix.sum() > 0 and got.speed["inference"] >= 0


def test_validator_forward_rows_match_jax(setup):
    """The rows each val batch's forward keeps, at both canvas shapes: classes equal,
    scores within rtol 1e-5, boxes within 1e-3 px (the predict tests' tolerances)."""
    from bsyolo_tpu.engine.validator import DetectionValidator as JV
    from bsyolo_tpu_torch.engine.validator import DetectionValidator

    jmodel, spec, variables, port, pspec, batches = setup
    jv, pv = JV(jmodel, spec, names=NAMES), DetectionValidator(port, pspec, names=NAMES, device="cpu")
    for b in batches:
        want = np.asarray(jv._forward(variables, b["img"]))
        got = pv._forward(None, nchw(b["img"])).numpy()
        assert got.shape == want.shape and (got[..., 4] > 0).sum() > 100
        np.testing.assert_array_equal(got[..., 5], want[..., 5])
        np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-3)


def _gt_forward(batches, seed):
    """A forward_fn returning each batch's ground truths as predictions: box sides jittered
    by 6 % of the box's size, one in five with the wrong class, seeded scores, two false positives per
    image, padded to 300 rows; calls are taken in loader order."""
    rng = np.random.default_rng(seed)
    out = []
    for b in batches:
        n, h, w = b["img"].shape[0], b["img"].shape[1], b["img"].shape[2]
        dets = np.zeros((n, 300, 6), np.float32)
        for i in range(n):
            m = b["mask"][i] > 0
            cx, cy, bw, bh = (b["bboxes"][i][m] * [w, h, w, h]).T
            size = np.stack([bw, bh, bw, bh], 1)
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1) + rng.normal(0, 0.06, size.shape) * size
            cls = np.where(rng.random(m.sum()) < 0.2, (b["cls"][i][m] + 1) % 3, b["cls"][i][m])
            fp = rng.uniform(0, min(h, w) - 8, (2, 2))
            rows = np.concatenate([
                np.concatenate([boxes, rng.uniform(0.3, 1.0, (m.sum(), 1)), cls[:, None]], 1),
                np.concatenate([fp, fp + 8, rng.uniform(0.01, 0.6, (2, 1)), rng.integers(0, 3, (2, 1))], 1),
            ])
            dets[i, : len(rows)] = rows
        out.append(dets)
    calls = iter(out)
    return lambda variables, img: next(calls)


@pytest.mark.parametrize("opts", [{}, {"single_cls": True}, {"classes": [0, 2]}], ids=["plain", "single_cls", "classes"])
def test_validator_with_forward_fn_matches_jax(setup, opts):
    from bsyolo_tpu.engine.validator import DetectionValidator as JV
    from bsyolo_tpu_torch.engine.validator import DetectionValidator

    jmodel, spec, variables, port, pspec, batches = setup
    want = JV(jmodel, spec, names=NAMES, forward_fn=_gt_forward(batches, 5), **opts)(None, batches, verbose=False)
    got = DetectionValidator(port, pspec, names=NAMES, device="cpu", forward_fn=_gt_forward(batches, 5), **opts)(
        None, _port_batches(batches), verbose=False)
    assert _results(want)[2] > 0.2  # mAP50: the jittered ground truths score
    np.testing.assert_allclose(_results(got), _results(want), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(got.confusion_matrix.matrix, want.confusion_matrix.matrix)


def test_validator_evaluates_the_variables_it_is_given(setup):
    """variables override the model's tensors by name for the evaluation only (the
    trainer passes its EMA parameters; BatchNorm statistics stay the model's own)."""
    from bsyolo_tpu_torch.engine.validator import DetectionValidator

    _, _, _, port, pspec, batches = setup
    v = DetectionValidator(port, pspec, names=NAMES, device="cpu")
    before = {k: t.clone() for k, t in port.state_dict().items()}
    shifted = {n: p.detach() * 0.5 for n, p in port.named_parameters()}
    img = nchw(batches[0]["img"])
    a, b = v._forward(None, img), v._forward(shifted, img)
    c = v._forward(dict(port.named_parameters()), img)
    assert not torch.equal(a, b) and torch.equal(a, c)
    for k, t in port.state_dict().items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)


def test_validator_options_not_ported_raise(setup):
    from bsyolo_tpu_torch.engine.validator import DetectionValidator

    _, _, _, port, pspec, _ = setup
    for kw in ({"plots": True},):
        with pytest.raises(NotImplementedError, match="item 16"):
            DetectionValidator(port, pspec, device="cpu", **kw)
