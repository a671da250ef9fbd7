"""The port's segment and pose data (data/cv.py fill_poly, data/augment.py's task transforms,
data/dataset.py's task labels and samples, utils/instance.py), their loader, trainer and facade
against bsyolo_tpu and OpenCV, on the CPU.

``cv.fill_poly`` is byte-equal to ``cv2.fillPoly`` (int32 points, 8-connected, no shift) on seeded
convex, concave, self-crossing, degenerate and out-of-frame polygons. Samples of seeded PNG
datasets (tests/torch_port.py write_task_dataset) from ``get_sample`` with the same generator:
boxes and keypoints within 1e-4, visibility and overlap masks equal, images as
tests/test_torch_data.py holds them for detect (at least 95 % of bytes equal, mean difference at
most 0.5). The facade: ``train`` one epoch from one JAX-written init.ckpt on tinyseg.yaml and
tinypose.yaml (imgsz 96, batch 8, amp=False, warps and HSV off as tests/test_torch_trainer.py's
EXACT_PIXELS), then ``val(save_json=True)`` and ``predict`` through ``YOLO("best.ckpt")``: loss
items within 2e-3, metrics within 1e-6, predictions.json's records alike, predict rows as
tests/test_torch_segment.py and tests/test_torch_pose.py hold them.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_port import write_task_dataset  # noqa: E402

FIX = Path(__file__).parent / "fixtures"
TINY = {"segment": str(FIX / "tinyseg.yaml"), "pose": str(FIX / "tinypose.yaml")}


def _polygon(kind, rng, h, w):
    k = int(rng.integers(3, 14))
    c = rng.uniform(0, [w, h])
    if kind == "convex":
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(1, max(h, w) / 2)
        return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1)
    if kind == "concave":  # a star
        ang = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False)
        r = np.where(np.arange(2 * k) % 2, rng.uniform(1, 4), rng.uniform(5, max(h, w, 12) / 2))
        return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1)
    if kind == "self-crossing":
        return rng.uniform(-3, [w + 3, h + 3], (k, 2))
    if kind == "degenerate":  # repeated points, collinear runs, single points and lines
        p = rng.uniform(0, [w, h], (int(rng.integers(1, 4)), 2))
        return np.repeat(p, int(rng.integers(1, 4)), 0)
    return rng.uniform(-4 * max(h, w), 5 * max(h, w), (k, 2))  # out of frame


@pytest.mark.parametrize("kind", ["convex", "concave", "self-crossing", "degenerate", "out-of-frame"])
def test_fill_poly_equals_opencv(kind):
    import cv2

    from bsyolo_tpu_torch.data.cv import fill_poly

    rng = np.random.default_rng(["convex", "concave", "self-crossing", "degenerate", "out-of-frame"].index(kind))
    for t in range(400):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        polys = [np.round(_polygon(kind, rng, h, w)).astype(np.int32) for _ in range(1 + (t % 4 == 0))]
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, polys, 1)
        got = fill_poly(np.zeros((h, w), np.uint8), polys, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {[p.tolist() for p in polys]}")
    # a resampled 1000-point polygon at mask size, as the loader fills them
    ang = np.linspace(0, 2 * np.pi, 1000, endpoint=False)
    p = (np.stack([80 + 50 * np.cos(ang), 70 + 30 * np.sin(3 * ang) + 20], -1)).astype(np.int32)
    want = cv2.fillPoly(np.zeros((160, 160), np.uint8), [p], 1)
    np.testing.assert_array_equal(fill_poly(np.zeros((160, 160), np.uint8), [p], 1), want)


def test_polygon_helpers_match_jax():
    from bsyolo_tpu.data import augment as J

    from bsyolo_tpu_torch.data import augment as P

    rng = np.random.default_rng(3)
    for n in (4, 7, 999, 1000, 1500):
        poly = rng.uniform(0, 50, (n, 2)).astype(np.float32)
        np.testing.assert_array_equal(P.resample_poly(poly, 1000), J.resample_poly(poly, 1000))
    for _ in range(50):
        seg = rng.uniform(-20, 80, (12, 2))
        np.testing.assert_array_equal(P.segment2box(seg, 64, 48), J.segment2box(seg, 64, 48))


@pytest.mark.parametrize("kind", ["segment", "pose"])
def test_warp_instance_labels_match_jax(kind):
    from bsyolo_tpu.data import augment as J

    from bsyolo_tpu_torch.data import augment as P

    rng = np.random.default_rng(4)
    n, k = 6, (30 if kind == "segment" else 5)
    boxes = np.sort(rng.uniform(0, 64, (n, 2, 2)), 1).reshape(n, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    pts = rng.uniform(0, 64, (n, k, 2)).astype(np.float32)
    vis = None if kind == "segment" else (rng.uniform(0, 1, (n, k)) < 0.7).astype(np.float32) * 2
    cls = rng.integers(0, 3, n).astype(np.float32)
    M = np.array([[1.1, 0.1, -5], [-0.05, 0.9, 12], [0, 0, 1]], np.float32)
    want = J.warp_instance_labels(cls, boxes, pts.copy(), None if vis is None else vis.copy(), M, 1.0, (64, 64), 0,
                                  kind)
    got = P.warp_instance_labels(cls, boxes, M, 1.0, (64, 64), 0, pts.copy(), None if vis is None else vis.copy(),
                                 kind)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def _datasets(root, task, augment, hyp=None):
    import bsyolo_tpu.data as J
    from bsyolo_tpu.cfg import DEFAULT_CFG_DICT

    import bsyolo_tpu_torch.data as P

    data = write_task_dataset(root, task, n_train=8, n_val=4, seed=5)
    out = []
    for M in (J, P):
        d = M.load_dataset_yaml(str(data))
        out.append(M.YOLODataset(d["train" if augment else "val"], imgsz=64, augment=augment,
                                 hyp=dict(DEFAULT_CFG_DICT, **(hyp or {})), max_gt=16, task=task,
                                 flip_idx=d.get("flip_idx")))
    return out


def _assert_samples_close(a, b):
    assert a.keys() == b.keys()
    for k in ("cls", "mask"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b["bboxes"], a["bboxes"], rtol=0, atol=1e-4)
    if "masks" in a:
        assert b["masks"].dtype == a["masks"].dtype
        np.testing.assert_array_equal(b["masks"], a["masks"])
    if "keypoints" in a:
        np.testing.assert_allclose(b["keypoints"][..., :2], a["keypoints"][..., :2], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(b["keypoints"][..., 2], a["keypoints"][..., 2])
    d = np.abs(a["img"].astype(np.int64) - b["img"].astype(np.int64))
    assert a["img"].shape == b["img"].shape and d.mean() <= 0.5 and np.mean(d == 0) >= 0.95


@pytest.mark.parametrize("task", ["segment", "pose"])
@pytest.mark.parametrize("augment,hyp", [(False, None), (True, None), (True, {"mosaic": 0.0, "degrees": 10.0}),
                                         (True, {"mixup": 1.0, "fliplr": 1.0})],
                         ids=["val", "train", "no-mosaic-rotated", "mixup-flipped"])
def test_task_samples_match_jax(tmp_path, task, augment, hyp):
    jds, pds = _datasets(tmp_path, task, augment, hyp)
    assert pds.labels and len(pds.segments if task == "segment" else pds.keypoints) == len(pds)
    n_inst = 0
    for i in range(len(pds)):
        a = jds.get_sample(i, np.random.default_rng(i))
        b = pds.get_sample(i, np.random.default_rng(i))
        _assert_samples_close(a, b)
        n_inst += int(b["mask"].sum())
    assert n_inst >= len(pds)


def test_pose_flip_swaps_keypoints_and_needs_flip_idx(tmp_path):
    """A horizontal flip carries each keypoint to the mirrored side's slot (flip_idx); without
    flip_idx a pose dataset is never flipped, as in the JAX package."""
    _, pds = _datasets(tmp_path, "pose", True, {"mosaic": 0.0, "fliplr": 1.0, "scale": 0.0, "translate": 0.0})
    _, plain = _datasets(tmp_path / "b", "pose", True, {"mosaic": 0.0, "fliplr": 0.0, "scale": 0.0,
                                                          "translate": 0.0})
    a = pds.get_sample(0, np.random.default_rng(1))
    b = plain.get_sample(0, np.random.default_rng(1))
    m = a["mask"] > 0
    ka, kb = a["keypoints"][m], b["keypoints"][m]
    np.testing.assert_allclose(ka[:, [1, 0, 3, 2], 0], 1 - kb[..., 0], atol=1e-5)
    np.testing.assert_array_equal(ka[:, [1, 0, 3, 2], 2], kb[..., 2])
    pds.flip_idx = None
    c = pds.get_sample(0, np.random.default_rng(1))
    np.testing.assert_array_equal(c["keypoints"], b["keypoints"])


def test_loader_collates_masks_and_keypoints_with_the_cfg_mask_ratio(tmp_path):
    from bsyolo_tpu_torch.data import DataLoader, YOLODataset, load_dataset_yaml

    for task, key, shape in (("segment", "masks", (4, 32, 32)), ("pose", "keypoints", (4, 16, 4, 3))):
        d = load_dataset_yaml(str(write_task_dataset(tmp_path / task, task, n_train=4, n_val=4)))
        ds = YOLODataset(d["train"], imgsz=64, augment=True, max_gt=16, task=task, mask_ratio=2,
                         flip_idx=d.get("flip_idx"))
        (batch,) = list(DataLoader(ds, 4, shuffle=True, seed=1))
        assert batch[key].shape == shape and batch["img"].shape == (4, 64, 64, 3)


def test_instances_match_jax():
    from bsyolo_tpu.utils import instance as J

    from bsyolo_tpu_torch.utils import instance as P

    rng = np.random.default_rng(6)
    boxes = np.concatenate([rng.uniform(0, 30, (5, 2)), rng.uniform(31, 60, (5, 2))], 1)
    segs = rng.uniform(0, 60, (5, 7, 2))
    kpts = np.concatenate([rng.uniform(0, 60, (5, 4, 2)), np.ones((5, 4, 1))], -1)
    out = []
    for M in (J, P):
        inst = M.Instances(boxes.copy(), segs.copy(), kpts.copy(), bbox_format="xyxy", normalized=False)
        inst.scale(0.5, 2.0)
        inst.add_padding(3, 4)
        inst.fliplr(64)
        inst.clip(60, 90)
        inst.convert_bbox("xywh")
        cat = M.Instances.concatenate([inst, inst[1:3]])
        out.append((cat.bboxes, cat.segments, cat.keypoints, M.Bboxes(boxes, "xyxy").areas(),
                    M._resample_segments(segs, 11)))
    for g, w in zip(out[1], out[0]):
        np.testing.assert_array_equal(g, w)


# --- the trainer and the facade, one epoch of each task -----------------------------------------
EXACT_PIXELS = dict(translate=0.0, scale=0.0, hsv_h=0.0, hsv_s=0.0, hsv_v=0.0)


def _write_init_ckpt(path, model, nc, names):
    from bsyolo_tpu.engine.train_step import init_train_state
    from bsyolo_tpu.engine.trainer import save_checkpoint
    from bsyolo_tpu.nn import build_model, load_model_yaml, parse_model_yaml

    d = load_model_yaml(model)
    d["nc"] = nc
    _, variables = build_model(parse_model_yaml(d), img_size=96, seed=7)
    save_checkpoint(Path(path), init_train_state(variables), {"args": {"model": model}, "epoch": -1,
                                                              "names": list(names)})


@pytest.fixture(scope="module", params=["segment", "pose"])
def legs(request, tmp_path_factory):
    """One JAX and one port facade run of ``train`` (1 epoch), ``val(save_json=True)`` and ``predict``
    through ``YOLO("best.ckpt")``, from one init.ckpt."""
    from bsyolo_tpu import YOLO as JYOLO

    from bsyolo_tpu_torch import YOLO

    task = request.param
    root = tmp_path_factory.mktemp(f"task_{task}")
    nc = 2 if task == "segment" else 1  # the graphs' own class counts: the JAX facade rebuilds a checkpoint's
    data = str(write_task_dataset(root / "ds", task, n_train=16, n_val=8, seed=2, nc=nc))  # graph with them
    _write_init_ckpt(root / "init.ckpt", TINY[task], nc, ("a", "b")[:nc])
    kw = dict(data=data, epochs=1, imgsz=96, batch=8, nbs=8, optimizer="SGD", lr0=0.01, workers=0, amp=False,
              plots=False, seed=3, max_gt=16, pretrained=str(root / "init.ckpt"), project=str(root / "runs"),
              close_mosaic=0, **EXACT_PIXELS)
    out = {"task": task}
    for side, cls, extra in (("jax", JYOLO, {}), ("port", YOLO, {"device": "cpu"})):
        m = cls(TINY[task], **extra)
        m.train(**kw, name=side)
        best = cls(str(root / "runs" / side / "weights" / "best.ckpt"), **extra)
        metrics = best.val(data=data, batch=8, imgsz=96, save_json=True, save_dir=str(root / "val" / side))
        frames = [np.random.default_rng(9).integers(0, 256, (80, 96, 3), dtype=np.uint8)]
        out[side] = {"trainer": m.trainer, "best": best, "metrics": metrics,
                     "json": json.loads((root / "val" / side / "predictions.json").read_text()),
                     "pred": best.predict(frames, imgsz=96, conf=0.001)}
    return out


def test_facade_train_val_predict_match_jax(legs):
    import csv

    j, p = legs["jax"], legs["port"]
    assert p["best"].task == legs["task"] and p["best"].spec.kpt_shape == j["best"].spec.kpt_shape
    rows = [list(csv.DictReader(open(x["trainer"].csv_path))) for x in (j, p)]
    assert rows[0][0].keys() == rows[1][0].keys()
    losses = [k for k in rows[0][0] if k.endswith("loss")]
    assert len(losses) == (5 if legs["task"] == "segment" else 6)
    for k in losses:
        np.testing.assert_allclose(float(rows[1][0][k]), float(rows[0][0][k]), rtol=2e-3, err_msg=k)
    jm, pm = j["metrics"].results_dict, p["metrics"].results_dict
    assert jm.keys() == pm.keys()
    np.testing.assert_allclose([float(pm[k]) for k in jm], [float(jm[k]) for k in jm], rtol=0, atol=1e-6)
    assert len(p["json"]) == len(j["json"]) > 0
    for a, b in zip(sorted(p["json"], key=lambda r: (str(r["image_id"]), -r["score"], r["bbox"])),
                    sorted(j["json"], key=lambda r: (str(r["image_id"]), -r["score"], r["bbox"]))):
        assert a["image_id"] == b["image_id"] and a["category_id"] == b["category_id"]
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=2e-3)
        if "keypoints" in b:
            np.testing.assert_allclose(a["keypoints"], b["keypoints"], atol=2e-3)
    (gp,), (gj,) = p["pred"], j["pred"]
    np.testing.assert_allclose(gp.boxes.data[:, :4], np.asarray(gj.boxes.data)[:, :4], rtol=0, atol=1e-3)
    if legs["task"] == "pose":
        np.testing.assert_allclose(gp.keypoints.data[..., :2], np.asarray(gj.keypoints.data)[..., :2], atol=1e-3)
    else:
        assert gp.masks.data.shape == np.asarray(gj.masks.data).shape
