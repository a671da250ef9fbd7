"""The port's OBB task (nn.heads OBB and decode_obb, ops/anchors dist2rbox, ops/obb, losses/obb, the
OBB sample and cv.min_area_rect, OBBValidator, the predictor's OBB branch and Results.obb,
data/split_dota, data/converter) against bsyolo_tpu and OpenCV, on the CPU.

tests/fixtures/tinyobb.yaml (nc 1) at imgsz 128 (96 for the loss), the same seeded weights on both
sides, carried from JAX variables. Gates: the parameter count of yolo11n-obb (nc 15 and 80) equal;
head maps within rtol 1e-4; decode_obb, dist2rbox, probiou, batch_probiou and xywhr2xyxyxyxy
within 1e-5 relative; nms_rotated keeping the same rows (classes equal, the rest within 1e-5);
rotated TAL masks identical; loss items within 2e-3 and their gradients on the head maps within
2e-3 of the largest; cv.convex_hull equal to cv2.convexHull and cv.min_area_rect within 2e-5
relative (centre), 3e-4 relative (size) and 1e-3 degrees of cv2.minAreaRect, or, where two
rectangles tie for the least area (squares, right triangles), one of the same area; collinear
points (no area) within the long side only, their hull too (ROADMAP, known differences); OBB samples: classes, masks and boxes as tests/test_torch_task_data.py holds
them, rboxes within 1e-4, or the same rectangle, or, for at most 1 in 10, a tie of equal area; validator metrics on the same rows within 1e-6; predict
rows within 1e-3 px (their save_txt corners within 1.5e-6 of the image size); split_dota windows, IoF within 1e-12, crops byte-equal; converter label
files equal; one epoch through the facade within 2e-3 of the JAX facade's loss items.
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import (nchw, port_batch, port_spec, task_models, variable_shapes,
                        write_obb_dataset)

OBB = str(Path(__file__).parent / "fixtures" / "tinyobb.yaml")
IMG = 128


@pytest.fixture(scope="module")
def obb():
    return task_models(OBB, IMG, seed=4)


@pytest.mark.parametrize("nc", [15, 80])
def test_parameter_count_at_full_width(nc):
    from bsyolo_tpu.nn import load_model_yaml as jload, parse_model_yaml as jparse
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.cfg import model_yaml_path
    from bsyolo_tpu_torch.nn.model import build_model, count_params
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    d = load_model_yaml(model_yaml_path("yolo11n-obb.yaml"))
    d["nc"] = nc
    spec = parse_model_yaml(d, scale="n")
    jd = jload(str(Path(__file__).parents[1] / "bsyolo_tpu/cfg/models/11/yolo11-obb.yaml"))
    jd["nc"] = nc
    shapes = variable_shapes(DetectionGraph(jparse(jd, scale="n")), (1, 64, 64, 3))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert spec.task == "obb" and spec.head.args[:2] == (nc, 1)
    assert count_params(build_model(spec, "cpu")) == want


def test_head_maps_and_decode_obb_match_jax(obb):
    from bsyolo_tpu.nn.heads import decode_obb as jdecode

    from bsyolo_tpu_torch.nn.heads import decode_obb

    jm, spec, v, port = obb
    x = np.random.default_rng(0).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.model(torch.from_numpy(nchw(x)))
    assert port.task == "obb"
    for g, w in zip(got, want):
        assert g.shape[1] == 64 + 1 + 1
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=1e-4, atol=1e-4)
    # decode the same maps on both sides
    wd = np.asarray(jdecode([jnp.asarray(g.numpy().transpose(0, 2, 3, 1)) for g in got], spec.head_strides,
                            spec.nc))
    gd = decode_obb(got, spec.head_strides, spec.nc).numpy()
    assert gd.shape == wd.shape == (2, 16 * 16 + 8 * 8, 4 + 1 + 1)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)


def _rboxes(rng, n, degenerate=False):
    rb = np.concatenate([rng.uniform(0, 100, (n, 2)), rng.uniform(1, 40, (n, 2)), rng.uniform(-1, 3, (n, 1))], 1)
    if degenerate:
        rb[::3, 2:4] = 0.0
        rb[1::3, 3] = 0.0
    return rb.astype(np.float32)


def test_geometry_matches_jax():
    """dist2rbox, probiou (with CIoU), batch_probiou on regular and zero-area boxes, xywhr2xyxyxyxy."""
    from bsyolo_tpu.ops import anchors as JA, obb as JO

    from bsyolo_tpu_torch.ops import anchors as PA, obb as PO

    rng = np.random.default_rng(1)
    dist = rng.uniform(0, 15, (2, 50, 4)).astype(np.float32)
    ang = rng.uniform(-0.8, 2.4, (2, 50, 1)).astype(np.float32)
    anc = rng.uniform(0, 20, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(PA.dist2rbox(*map(torch.from_numpy, (dist, ang, anc))).numpy(),
                               np.asarray(JA.dist2rbox(jnp.asarray(dist), jnp.asarray(ang), jnp.asarray(anc))),
                               rtol=1e-5, atol=1e-5)
    for degenerate in (False, True):
        a, b = _rboxes(rng, 30, degenerate), _rboxes(rng, 30)
        for ciou in (False, True):
            np.testing.assert_allclose(PO.probiou(torch.from_numpy(a), torch.from_numpy(b), CIoU=ciou).numpy(),
                                       np.asarray(JO.probiou(jnp.asarray(a), jnp.asarray(b), CIoU=ciou)),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(PO.batch_probiou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                   np.asarray(JO.batch_probiou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(PO.xywhr2xyxyxyxy(torch.from_numpy(a)).numpy(),
                                   np.asarray(JO.xywhr2xyxyxyxy(jnp.asarray(a))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nc,max_det,pre_k", [(1, 300, 512), (3, 20, 64)])
def test_nms_rotated_keeps_the_rows_jax_keeps(nc, max_det, pre_k):
    from bsyolo_tpu.ops.obb import nms_rotated as jnms

    from bsyolo_tpu_torch.ops.obb import nms_rotated

    rng = np.random.default_rng(nc)
    b, a = 2, 400
    centers = rng.uniform(0, 120, (b, 25, 2))
    pick = rng.integers(0, 25, (b, a))
    xy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 3, (b, a, 2))
    pred = np.concatenate([xy, rng.uniform(4, 30, (b, a, 2)), rng.uniform(0, 1, (b, a, nc)) ** 3,
                           rng.uniform(-0.7, 2.3, (b, a, 1))], -1).astype(np.float32)
    want = np.asarray(jnms(jnp.asarray(pred), conf_thres=0.2, iou_thres=0.45, max_det=max_det, pre_k=pre_k, nc=nc))
    got = nms_rotated(torch.from_numpy(pred), conf_thres=0.2, iou_thres=0.45, max_det=max_det, pre_k=pre_k,
                      nc=nc).numpy()
    assert got.shape == want.shape and (got[..., 4] > 0).sum() > 20
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _obb_batch(seed, b, m, nc):
    rng = np.random.default_rng(seed)
    rb = np.concatenate([rng.uniform(0.25, 0.75, (b, m, 2)), rng.uniform(0.1, 0.4, (b, m, 1)),
                         rng.uniform(0.05, 0.2, (b, m, 1)), rng.uniform(-0.7, 2.3, (b, m, 1))], -1)
    return {"cls": rng.integers(0, nc, (b, m)).astype(np.int32), "rboxes": rb.astype(np.float32),
            "mask": (rng.uniform(0, 1, (b, m)) < 0.8).astype(np.float32)}


def _loss_inputs(obb, size, seed=3):
    jm, spec, v, _ = obb
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    x = np.random.default_rng(seed).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    jout = jm.apply(v, jnp.asarray(x), train=False)
    pm = build_model(port_spec(OBB), "cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        pout = pm(torch.from_numpy(nchw(x)))
    return spec, jout, pout


def test_rotated_tal_and_obb_loss_match_jax(obb):
    from bsyolo_tpu.losses.detect import DetectionLossConfig as JC, init_loss_state as jinit
    from bsyolo_tpu.losses.obb import obb_loss as jloss, rotated_task_aligned_assign as jassign

    from bsyolo_tpu_torch.losses import DetectionLossConfig, init_loss_state, obb_loss, rotated_task_aligned_assign

    spec, jout, pout = _loss_inputs(obb, 96)
    batch = _obb_batch(5, 2, 6, spec.nc)
    jcfg, pcfg = JC(nc=spec.nc, strides=spec.head_strides), DetectionLossConfig(nc=spec.nc, strides=spec.head_strides)

    def jtotal(feats):
        return jloss(feats, *(jnp.asarray(batch[k]) for k in ("cls", "rboxes", "mask")), jinit(), jcfg)

    jitems = np.asarray(jtotal(jout)[1])
    jgrads = jax.grad(lambda f: jtotal(f)[0])(jout)
    feats = [f.clone().requires_grad_(True) for f in pout]
    t = {k: torch.from_numpy(batch[k]) for k in batch}
    total, items, _ = obb_loss(feats, t["cls"].long(), t["rboxes"], t["mask"], init_loss_state(), pcfg)
    total.backward()
    assert items.shape == (3,) and float(items[0]) > 0
    np.testing.assert_allclose(items.detach().numpy(), jitems, rtol=2e-3, atol=1e-6)
    for f, g in zip(feats, jgrads):
        g = nchw(g)
        np.testing.assert_allclose(f.grad.numpy(), g, rtol=0, atol=2e-3 * np.abs(g).max())

    # the assignment inside, on the same decoded boxes and scores
    rng = np.random.default_rng(6)
    a = 300
    anc = rng.uniform(0, 96, (a, 2)).astype(np.float32)
    pd = np.concatenate([anc[None].repeat(2, 0) + rng.normal(0, 4, (2, a, 2)), rng.uniform(5, 40, (2, a, 2)),
                         rng.uniform(-0.7, 2.3, (2, a, 1))], -1).astype(np.float32)
    sc = rng.uniform(0, 1, (2, a, 3)).astype(np.float32)
    gt = (batch["rboxes"] * [96, 96, 96, 96, 1]).astype(np.float32)
    gl = rng.integers(0, 3, (2, 6)).astype(np.int32)
    w = jassign(*(jnp.asarray(z) for z in (sc, pd, anc, gl, gt, batch["mask"])), topk=10, num_classes=3)
    g = rotated_task_aligned_assign(*(torch.from_numpy(z) for z in (sc, pd, anc, gl, gt, batch["mask"])), topk=10,
                                    num_classes=3)
    assert int(np.asarray(w[2]).sum()) > 10
    np.testing.assert_array_equal(g.fg_mask.numpy(), np.asarray(w[2]))
    np.testing.assert_array_equal(g.target_gt_idx.numpy(), np.asarray(w[3]))
    np.testing.assert_allclose(g.target_scores.numpy(), np.asarray(w[1]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(g.target_rboxes.numpy(), np.asarray(w[0]), rtol=0, atol=0)


def test_obb_loss_grads_finite_with_zero_instances(obb):
    """An image with no instances: every anchor's target is the zero padding row, whose probIoU
    square root is floored, so the gradients stay finite (tests/test_tasks.py's JAX case)."""
    from bsyolo_tpu_torch.losses import DetectionLossConfig, init_loss_state, obb_loss
    from bsyolo_tpu_torch.nn.model import build_model

    model = build_model(port_spec(OBB), "cpu")
    rboxes = torch.zeros(2, 4, 5)
    rboxes[0, 0] = torch.tensor([0.5, 0.5, 0.4, 0.2, 0.4])
    mask = torch.zeros(2, 4)
    mask[0, 0] = 1
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
    total, _, _ = obb_loss(model(x), torch.zeros(2, 4, dtype=torch.long), rboxes, mask, init_loss_state(),
                           DetectionLossConfig(nc=1, strides=model.spec.head_strides))
    total.backward()
    assert torch.isfinite(total) and all(torch.isfinite(p.grad).all() for p in model.parameters())


def _rect(rng, cx, cy, w, h, r):
    c, s = math.cos(r), math.sin(r)
    d = np.array([[w / 2, h / 2], [-w / 2, h / 2], [-w / 2, -h / 2], [w / 2, -h / 2]])
    return (d @ np.array([[c, s], [-s, c]]) + [cx, cy]).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "rectangles", "squares", "thin", "near-90", "axis", "degenerate",
                                  "right-triangles"])
def test_min_area_rect_matches_opencv(kind):
    import cv2

    from bsyolo_tpu_torch.data.cv import convex_hull, min_area_rect

    rng = np.random.default_rng(len(kind))
    ties = 0
    for t in range(300):
        if kind == "random":
            p = rng.uniform(0, 1000, (int(rng.integers(3, 12)), 2)).astype(np.float32)
        elif kind == "degenerate":  # one point, repeated points, collinear runs
            q = rng.uniform(0, 50, (2, 2))
            p = np.concatenate([q, q[:1] + (q[1] - q[0]) * rng.uniform(0, 2, (3, 1))])[: int(rng.integers(1, 6))]
            p = np.round(p).astype(np.float32) if t % 2 else p.astype(np.float32)
        elif kind == "right-triangles":  # corners clipped at a canvas edge: two rectangles of equal area
            x0, y0, a, b = *rng.uniform(0, 50, 2), *rng.uniform(2, 30, 2) * rng.choice([-1, 1], 2)
            p = np.float32([[x0, y0], [x0 + a, y0], [x0, y0 + b]])
        else:
            w = rng.uniform(1, 40)
            h = {"squares": w, "thin": rng.uniform(0.5, 2.0)}.get(kind, rng.uniform(1, 40))
            r = {"near-90": np.pi / 2 - rng.uniform(0, 1e-3), "axis": 0.0}.get(kind, rng.uniform(-np.pi, np.pi))
            p = _rect(rng, *rng.uniform(10, 90, 2), w, h, r)
        if kind != "degenerate" or t % 2:  # nearly collinear floats: the hull may keep a point OpenCV drops
            np.testing.assert_array_equal(convex_hull(p), cv2.convexHull(p).reshape(-1, 2))
        (cx, cy), (bw, bh), a = min_area_rect(p)
        (wx, wy), (ww, wh), wa = cv2.minAreaRect(p)
        if kind == "right-triangles":  # a tie between two rectangles: the same least area
            np.testing.assert_allclose(bw * bh, ww * wh, rtol=1e-4)
            ties += abs(a - wa) > 1e-3
            continue
        np.testing.assert_allclose([cx, cy], [wx, wy], rtol=2e-5, atol=1e-5)
        if kind == "degenerate" and t % 2 == 0:  # collinear: no area, an angle OpenCV leaves unnormalized
            np.testing.assert_allclose(max(bw, bh), max(ww, wh), rtol=3e-4)
            assert min(bw, bh) < 1e-4 * max(bw, bh, 1) and min(ww, wh) < 1e-4 * max(ww, wh, 1)
            continue
        assert -90 <= a < 0 and -90 <= wa < 0
        if kind == "squares":  # a tie between the sides: the same rectangle, maybe described from the other side
            np.testing.assert_allclose(sorted([bw, bh]), sorted([ww, wh]), rtol=3e-4, atol=1e-5)
            continue
        np.testing.assert_allclose([bw, bh], [ww, wh], rtol=3e-4, atol=1e-5 * max(ww, wh))
        assert abs(a - wa) < 1e-3, (p, a, wa)
    assert ties < 30  # about 1 in 40 right triangles take the other rectangle


def test_rbox_from_corners_matches_jax():
    from bsyolo_tpu.data.dataset import _rbox_from_corners as jfit

    from bsyolo_tpu_torch.data.dataset import _rbox_from_corners

    rng = np.random.default_rng(3)
    for t in range(200):
        w = rng.uniform(0.05, 0.5)
        p = _rect(rng, *rng.uniform(0.2, 0.8, 2), w, w * rng.uniform(0.1, 0.8), rng.uniform(-np.pi, np.pi))
        got, want = _rbox_from_corners(p), jfit(p)
        assert -np.pi / 4 <= got[4] < 3 * np.pi / 4 and got[2] >= got[3]
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _equal_or_same_rect(got, want):
    """Rows of xywhr equal within 1e-4, or describing the same rectangle (width and height swapped
    with the angle turned by 90 degrees), or a rectangle of the same area (a tie in minAreaRect);
    returns which rows are equal or the same rectangle."""
    from bsyolo_tpu_torch.ops.obb import xywhr2xyxyxyxy

    same = np.all(np.abs(got - want) <= 1e-4, -1)
    cg = xywhr2xyxyxyxy(torch.from_numpy(got)).numpy()
    cw = xywhr2xyxyxyxy(torch.from_numpy(want)).numpy()
    rect = np.all(np.abs(np.sort(cg.reshape(-1, 8), -1) - np.sort(cw.reshape(-1, 8), -1)) <= 1e-4, -1)
    tie = np.abs(got[:, 2] * got[:, 3] - want[:, 2] * want[:, 3]) <= 1e-4 * np.maximum(want[:, 2] * want[:, 3], 1e-6)
    assert np.all(same | rect | tie), (got[~(same | rect | tie)], want[~(same | rect | tie)])
    return same | rect


@pytest.mark.parametrize("augment,hyp", [(False, None), (True, None), (True, {"mosaic": 0.0, "degrees": 30.0}),
                                         (True, {"mixup": 1.0, "fliplr": 1.0, "flipud": 0.5})],
                         ids=["val", "train", "no-mosaic-rotated", "mixup-flipped"])
def test_obb_samples_match_jax(tmp_path, augment, hyp):
    import bsyolo_tpu.data as J
    from bsyolo_tpu.cfg import DEFAULT_CFG_DICT

    import bsyolo_tpu_torch.data as P

    data = write_obb_dataset(tmp_path, n_train=8, n_val=4, seed=5, nc=2)
    jds, pds = (M.YOLODataset(M.load_dataset_yaml(str(data))["train" if augment else "val"], imgsz=64,
                              augment=augment, hyp=dict(DEFAULT_CFG_DICT, **(hyp or {})), max_gt=16, task="obb")
                for M in (J, P))
    for i in range(len(pds)):
        assert len(pds.rcorners[i]) == len(jds.rcorners[i])
        for a, b in zip(pds.rcorners[i], jds.rcorners[i]):
            np.testing.assert_array_equal(a, b)
    n_same = n_inst = 0
    for i in range(len(pds)):
        a = jds.get_sample(i, np.random.default_rng(i))
        b = pds.get_sample(i, np.random.default_rng(i))
        assert a.keys() == b.keys() and "rboxes" in b
        for k in ("cls", "mask"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        np.testing.assert_allclose(b["bboxes"], a["bboxes"], rtol=0, atol=1e-4)
        n_same += int(_equal_or_same_rect(b["rboxes"], a["rboxes"]).sum())
        n_inst += len(b["rboxes"])
        d = np.abs(a["img"].astype(np.int64) - b["img"].astype(np.int64))
        assert a["img"].shape == b["img"].shape and d.mean() <= 0.5 and np.mean(d == 0) >= 0.95
    assert n_same >= 0.9 * n_inst


def _rotated_rows(batches, rng, max_det=20):
    """(B, max_det, 7) rows x, y, w, h, conf, cls, angle from each batch's ground truths in input pixels,
    jittered, with random scores and two false rows; padding rows zero with class -1."""
    out = []
    for bt in batches:
        b, h, w = bt["img"].shape[:3]
        rows = np.zeros((b, max_det, 7), np.float32)
        rows[..., 5] = -1
        for i in range(b):
            m = bt["mask"][i] > 0
            rb = bt["rboxes"][i][m] * [w, h, w, h, 1]
            r = np.concatenate([rb[:, :2] + rng.uniform(-2, 2, (len(rb), 2)), rb[:, 2:4] * rng.uniform(0.9, 1.1, (len(rb), 2)),
                                rng.uniform(0.3, 1, (len(rb), 1)), bt["cls"][i][m, None], rb[:, 4:5] + rng.normal(0, 0.05, (len(rb), 1))], 1)
            false = np.concatenate([rng.uniform(5, 30, (2, 2)), rng.uniform(3, 9, (2, 2)), rng.uniform(0.01, 0.3, (2, 1)),
                                    rng.integers(0, 2, (2, 1)), rng.uniform(0, 1, (2, 1))], 1)
            r = np.concatenate([r, false])[:max_det]
            rows[i, : len(r)] = r
        out.append(rows)
    return out


def test_validator_metrics_and_json_match_jax(obb, tmp_path):
    """Both validators over the JAX loader's batches of a seeded OBB dataset, fed the same rows (the
    ground truths, jittered); predictions.json's records alike."""
    from bsyolo_tpu.data import DataLoader, YOLODataset, load_dataset_yaml
    from bsyolo_tpu.engine.validator import OBBValidator as JVal

    from bsyolo_tpu_torch.engine.validator import OBBValidator

    jm, spec, v, port = obb
    data = write_obb_dataset(tmp_path / "ds", n_train=1, n_val=10, nc=2, seed=7)
    d = load_dataset_yaml(str(data))
    ds = YOLODataset(d["val"], imgsz=64, augment=False, max_gt=16, task="obb")
    batches = [{k: np.asarray(x) for k, x in b.items()} for b in DataLoader(ds, 4, shuffle=False, drop_last=False)]
    rows = _rotated_rows(batches, np.random.default_rng(11))
    it = iter(rows)
    jv = JVal(jm, spec, names={0: "a", 1: "b"}, save_json=True, save_dir=str(tmp_path / "j"))
    jv._forward = lambda variables, img: jnp.asarray(next(it))

    class _Loader(list):
        dataset = ds

    want = jv(v, _Loader(batches))
    it2 = iter(rows)
    pv = OBBValidator(port.model, port.spec, names={0: "a", 1: "b"}, device="cpu", save_json=True,
                      save_dir=str(tmp_path / "p"), forward_fn=lambda variables, img: torch.from_numpy(next(it2)))
    got = pv(None, [port_batch(b) for b in batches], im_files=ds.img_files)
    assert want.box.map50 > 0.1
    assert got.results_dict.keys() == want.results_dict.keys()
    np.testing.assert_allclose([float(x) for x in got.results_dict.values()],
                               [float(x) for x in want.results_dict.values()], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.confusion_matrix.matrix, want.confusion_matrix.matrix)
    pj, jj = (json.loads((tmp_path / s / "predictions.json").read_text()) for s in ("p", "j"))
    assert len(pj) == len(jj) > 10
    for a, b in zip(pj, jj):
        assert a["image_id"] == b["image_id"] and a["category_id"] == b["category_id"] and a["score"] == b["score"]
        np.testing.assert_allclose(a["rbox"] + a["poly"], b["rbox"] + b["poly"], atol=2e-3)


def test_predict_rows_results_and_json_match_jax(obb, tmp_path):
    import cv2

    from bsyolo_tpu.engine.predictor import DetectionPredictor
    from bsyolo_tpu.engine.results import Results as JResults
    from bsyolo_tpu.utils.coco import obb_pred_to_json as jjson

    from bsyolo_tpu_torch.utils.coco import obb_pred_to_json

    jm, spec, v, port = obb
    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), rng.integers(0, 256, (128, 100, 3), dtype=np.uint8),
              cv2.imread(str(Path(__file__).parent / "fixtures/bsyolo8/images/train/1.jpg"))]
    want = DetectionPredictor(jm, spec, v, conf=0.05, imgsz=IMG, batch=3, names=port.names)(frames)
    got = port.predict(frames, imgsz=IMG, conf=0.05, batch=3)
    for g, w in zip(got, want):
        gd, wd = g.obb.data, np.asarray(w.obb.data)
        assert gd.shape == wd.shape and len(gd) > 3 and g.boxes is None
        np.testing.assert_array_equal(gd[:, 5], wd[:, 5])
        np.testing.assert_allclose(gd[:, :4], wd[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(gd[:, 4:], wd[:, 4:], rtol=0, atol=1e-5)
    r = got[0]
    j = JResults(frames[0], "f.jpg", port.names, obb=r.obb.data)
    for conf in (False, True):  # corners from sin and cos of float32 angles: the 6th decimal may differ by 1
        r.save_txt(tmp_path / f"p{conf}.txt", save_conf=conf)
        j.save_txt(tmp_path / f"j{conf}.txt", save_conf=conf)
        pl, jl = ([[float(x) for x in line.split()] for line in (tmp_path / f"{s}{conf}.txt").read_text().splitlines()]
                  for s in "pj")
        assert len(pl) == len(jl) == len(r) and all(len(x) == (10 if conf else 9) for x in pl)
        np.testing.assert_allclose(np.array(pl), np.array(jl), rtol=0, atol=1.5e-6)
    assert r.summary() == j.summary() and r.summary(normalize=True) == j.summary(normalize=True)
    np.testing.assert_allclose(r.obb.xyxyxyxy, j.obb.xyxyxyxy, rtol=1e-6, atol=1e-5)
    assert len(r) == len(r.obb) and len(r[1:3].obb) == 2 and r.verbose_line
    assert obb_pred_to_json(r.obb.data, "images/7.jpg", [3]) == jjson(r.obb.data, "images/7.jpg", [3])
    for kw in ({}, {"labels": False}, {"conf": False, "line_width": 1}, {"boxes": False}):  # drawn as JAX draws
        assert np.array_equal(r.plot(**kw), j.plot(**kw))


def test_split_dota_matches_jax(tmp_path):
    """Windows, the batched polygon IoF and whole-directory splits (labels equal, crops byte-equal to
    the JAX package's cv2.imwrite crops) against bsyolo_tpu/data/split_dota.py."""
    import cv2

    from bsyolo_tpu.data import split_dota as J

    from bsyolo_tpu_torch.data import split_dota as P

    for size in ((1500, 2100), (800, 900), (3000, 1100)):
        for crop, gap in (((1024,), (200,)), ((512, 768), (100, 200))):
            np.testing.assert_array_equal(P.get_windows(size, crop, gap), J.get_windows(size, crop, gap))
    rng = np.random.default_rng(4)
    polys = np.concatenate([_rect(rng, *rng.uniform(0, 600, 2), *rng.uniform(5, 80, 2), rng.uniform(-3, 3)).reshape(1, 8)
                            for _ in range(40)]).astype(np.float64)
    wins = P.get_windows((600, 600), (256,), (64,))
    np.testing.assert_allclose(P.bbox_iof(polys, wins), J.bbox_iof(polys, wins), rtol=0, atol=1e-12)
    src = tmp_path / "dota"
    (src / "images" / "train").mkdir(parents=True)
    (src / "labels" / "train").mkdir(parents=True)
    for i in range(2):
        img = rng.integers(0, 256, (700 + 100 * i, 900, 3), dtype=np.uint8)
        cv2.imwrite(str(src / "images" / "train" / f"P{i}.png"), img)
        rows = [f"{int(rng.integers(0, 15))} " + " ".join(f"{v:.1f}" for v in
                _rect(rng, *rng.uniform(50, 650, 2), *rng.uniform(10, 90, 2), rng.uniform(-3, 3)).reshape(-1))
                for _ in range(12)]
        (src / "labels" / "train" / f"P{i}.txt").write_text("\n".join(rows) + "\n")
    n_j = J.split_trainval(str(src), str(tmp_path / "j"), crop_size=512, gap=100)
    n_p = P.split_trainval(str(src), str(tmp_path / "p"), crop_size=512, gap=100)
    assert n_p == n_j >= 8
    for f in sorted((tmp_path / "j").rglob("*.*")):
        g = tmp_path / "p" / f.relative_to(tmp_path / "j")
        assert g.read_bytes() == f.read_bytes(), g


def test_converter_matches_jax(tmp_path):
    from bsyolo_tpu.data import converter as J

    from bsyolo_tpu_torch.data import converter as P

    assert P.coco91_to_coco80() == J.coco91_to_coco80()
    rng = np.random.default_rng(8)
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "width": 640, "height": 480} for i in range(4)]
    anns = [{"id": k, "image_id": k % 4, "category_id": int(rng.choice([1, 3, 12, 44, 90])), "iscrowd": int(k == 5),
             "bbox": [float(x) for x in rng.uniform(0, 300, 4)],
             "segmentation": [[float(x) for x in rng.uniform(0, 400, 8)]] if k % 2 else []} for k in range(12)]
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    for seg in (False, True):
        for c80 in (True, False):
            a = J.convert_coco(str(ann), str(tmp_path / f"j{seg}{c80}"), use_segments=seg, cls91to80=c80)
            b = P.convert_coco(str(ann), str(tmp_path / f"p{seg}{c80}"), use_segments=seg, cls91to80=c80)
            fa, fb = sorted(a.glob("*.txt")), sorted(b.glob("*.txt"))
            assert [f.name for f in fa] == [f.name for f in fb] and len(fa) == 4
            assert all(x.read_text() == y.read_text() for x, y in zip(fa, fb))
    for side, M in (("j", J), ("p", P)):
        root = tmp_path / f"auto_{side}" / "images"
        root.mkdir(parents=True)
        for i in range(12):
            (root / f"{i}.jpg").write_bytes(b"x")
        assert M.autosplit(root, weights=(0.6, 0.3, 0.1), seed=2) is not None
    for n in ("autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt"):
        a, b = tmp_path / "auto_j" / n, tmp_path / "auto_p" / n
        assert a.exists() == b.exists() and (not a.exists() or a.read_text() == b.read_text())
    imgs = tmp_path / "gimgs"
    imgs.mkdir()
    (imgs / "a.jpg").write_bytes(b"x")
    gj = {"images": [{"id": 1, "file_name": "a.jpg", "width": 100, "height": 50, "caption": "a red car: near a dog"}],
          "annotations": [{"image_id": 1, "bbox": [1, 2, 30, 20], "tokens_positive": [[0, 9]]},
                          {"image_id": 1, "bbox": [40, 5, 10, 10], "tokens_positive": [[18, 21]]}]}
    (tmp_path / "g.json").write_text(json.dumps(gj))
    ya = Path(J.convert_grounding(str(tmp_path / "g.json"), str(imgs), str(tmp_path / "gj")))
    yb = Path(P.convert_grounding(str(tmp_path / "g.json"), str(imgs), str(tmp_path / "gp")))
    assert ya.read_text().replace(str(ya.parent.resolve()), "") == yb.read_text().replace(str(yb.parent.resolve()), "")
    assert (ya.parent / "labels/train/a.txt").read_text() == (yb.parent / "labels/train/a.txt").read_text()


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """One JAX and one port facade run of ``train`` (1 epoch), ``val(save_json=True)`` and ``predict``
    through ``YOLO("best.ckpt")``, from one init.ckpt."""
    from bsyolo_tpu import YOLO as JYOLO

    from bsyolo_tpu_torch import YOLO
    from test_torch_task_data import EXACT_PIXELS, _write_init_ckpt

    root = tmp_path_factory.mktemp("obb")
    data = str(write_obb_dataset(root / "ds", n_train=16, n_val=8, seed=2, nc=1))
    _write_init_ckpt(root / "init.ckpt", OBB, 1, ("c0",))
    kw = dict(data=data, epochs=1, imgsz=96, batch=8, nbs=8, optimizer="SGD", lr0=0.01, workers=0, amp=False,
              plots=False, seed=3, max_gt=16, pretrained=str(root / "init.ckpt"), project=str(root / "runs"),
              close_mosaic=0, **EXACT_PIXELS)
    out = {}
    for side, cls, extra in (("jax", JYOLO, {}), ("port", YOLO, {"device": "cpu"})):
        m = cls(OBB, **extra)
        m.train(**kw, name=side)
        best = cls(str(root / "runs" / side / "weights" / "best.ckpt"), **extra)
        metrics = best.val(data=data, batch=8, imgsz=96, save_json=True, save_dir=str(root / "val" / side))
        frames = [np.random.default_rng(9).integers(0, 256, (80, 96, 3), dtype=np.uint8)]
        out[side] = {"trainer": m.trainer, "best": best, "metrics": metrics,
                     "json": json.loads((root / "val" / side / "predictions.json").read_text()),
                     "pred": best.predict(frames, imgsz=96, conf=0.001)}
    out["data"] = data
    return out


def test_facade_train_val_predict_match_jax(legs):
    import csv

    j, p = legs["jax"], legs["port"]
    assert p["best"].task == "obb"
    rows = [list(csv.DictReader(open(x["trainer"].csv_path))) for x in (j, p)]
    assert rows[0][0].keys() == rows[1][0].keys()
    losses = [k for k in rows[0][0] if k.endswith("loss")]
    assert len(losses) == 4
    for k in losses:
        np.testing.assert_allclose(float(rows[1][0][k]), float(rows[0][0][k]), rtol=2e-3, err_msg=k)
    jm, pm = j["metrics"].results_dict, p["metrics"].results_dict
    assert jm.keys() == pm.keys()
    np.testing.assert_allclose([float(pm[k]) for k in jm], [float(jm[k]) for k in jm], rtol=0, atol=1e-6)
    assert len(p["json"]) == len(j["json"]) > 0
    key = lambda r: (str(r["image_id"]), -r["score"], r["rbox"])
    for a, b in zip(sorted(p["json"], key=key), sorted(j["json"], key=key)):
        assert a["image_id"] == b["image_id"] and a["category_id"] == b["category_id"]
        np.testing.assert_allclose(a["rbox"], b["rbox"], atol=2e-3)
    (gp,), (gj,) = p["pred"], j["pred"]
    np.testing.assert_allclose(gp.obb.data, np.asarray(gj.obb.data), rtol=0, atol=1e-3)


def test_cli_obb_task(legs, capsys):
    from bsyolo_tpu_torch.cli import TASK_MODELS, main

    assert TASK_MODELS["obb"] == "yolo11n-obb.yaml"
    best = str(Path(legs["port"]["trainer"].save_dir) / "weights" / "best.ckpt")
    assert main(["obb", "val", f"model={best}", "device=cpu", f"data={legs['data']}", "batch=8", "imgsz=96"]) == 0
    assert "metrics/mAP50(B)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="OBB head"):
        main(["pose", "val", f"model={best}", "device=cpu", f"data={legs['data']}"])


def test_classes_filter_applies_to_obb_rows(obb):
    """``predict(classes=...)`` keeps the rotated rows of those classes; the JAX predictor's OBB branch
    ignores ``classes`` (a fault not copied)."""
    from bsyolo_tpu.engine.predictor import DetectionPredictor

    jm, spec, v, port = obb
    frame = np.random.default_rng(15).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    (kept,) = port.predict(frame, imgsz=IMG, conf=0.05, classes=[0])
    (none,) = port.predict(frame, imgsz=IMG, conf=0.05, classes=[1])
    (jax_none,) = DetectionPredictor(jm, spec, v, conf=0.05, imgsz=IMG, classes=[1], names=port.names)([frame])
    assert len(kept) > 3 and len(none) == 0 and none.obb.data.shape == (0, 7)
    assert len(jax_none.obb) == len(kept)
