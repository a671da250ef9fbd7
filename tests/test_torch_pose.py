"""The port's Pose task (nn.heads Pose and decode_keypoints, the pose predictor, results,
validator, loss and train step, OKS, utils.coco keypoint results) against bsyolo_tpu, on the CPU.

tests/fixtures/tinypose.yaml (nc 1, 4 keypoints x, y, visibility) at imgsz 128 (96 for the loss
and the step), the same seeded weights on both sides, carried from JAX variables. Gates: the
parameter count of yolo11n-pose (17 x 3) at full width equal; head maps within rtol 1e-4;
decoded keypoints within 1e-3 px and visibility within 1e-6; predict rows with equal kept
anchor indices, classes equal, boxes and keypoints within 1e-3 px, visibility within 1e-6; TAL
masks identical and loss items within 2e-3; one SGD step within
tests/test_torch_train_step.py's gate; validator metrics on the same detections within 1e-6;
OKS and COCO dicts equal.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import (jax_assign_weight, jax_spec, jax_val_batches, jittered_gt_rows, nchw, port_batch, port_spec,
                        task_batch, task_models, variable_shapes, write_task_dataset)

POSE = str(Path(__file__).parent / "fixtures" / "tinypose.yaml")
IMG = 128


@pytest.fixture(scope="module")
def pose():
    return task_models(POSE, IMG, seed=6)


def test_parameter_count_at_full_width():
    from bsyolo_tpu.nn.model import DetectionGraph

    from bsyolo_tpu_torch.nn.model import build_model, count_params

    spec = port_spec("yolo11n-pose.yaml")
    assert spec.task == "pose" and spec.kpt_shape == (17, 3)
    shapes = variable_shapes(DetectionGraph(jax_spec("yolo11n-pose.yaml")), (1, 64, 64, 3))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert count_params(build_model(spec, "cpu")) == want


def test_head_maps_and_keypoint_decode_match_jax(pose):
    from bsyolo_tpu.nn.heads import decode_extras as jextras, decode_keypoints as jkpts

    from bsyolo_tpu_torch.nn.heads import decode_extras, decode_keypoints

    jm, spec, v, port = pose
    x = np.random.default_rng(0).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.model(torch.from_numpy(nchw(x)))
    assert port.task == "pose" and port.spec.kpt_shape == (4, 3)
    for g, w in zip(got, want):
        assert g.shape[1] == 64 + 1 + 12
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=1e-4, atol=1e-4)
    wk = np.asarray(jkpts(jextras(want, spec.nc), want, spec.head_strides, spec.kpt_shape))
    gk = decode_keypoints(decode_extras(got, spec.nc), got, spec.head_strides, spec.kpt_shape).numpy()
    np.testing.assert_allclose(gk[..., :2], wk[..., :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(gk[..., 2], wk[..., 2], rtol=0, atol=1e-6)


def test_predict_rows_and_keypoints_match_jax(pose):
    import cv2

    from bsyolo_tpu.engine.predictor import DetectionPredictor

    jm, spec, v, port = pose
    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8), rng.integers(0, 256, (128, 100, 3), dtype=np.uint8),
              cv2.imread(str(Path(__file__).parent / "fixtures/bsyolo8/images/train/1.jpg"))]
    want = DetectionPredictor(jm, spec, v, conf=0.05, imgsz=IMG, batch=3, names=port.names)(frames)
    got = port.predict(frames, imgsz=IMG, conf=0.05, batch=3)
    for g, w in zip(got, want):
        gd, wd = g.boxes.data, np.asarray(w.boxes.data)
        assert gd.shape == wd.shape and len(gd) > 3 and g.masks is None
        np.testing.assert_array_equal(gd[:, 5], wd[:, 5])
        np.testing.assert_allclose(gd[:, :4], wd[:, :4], rtol=0, atol=1e-3)
        gk, wk = g.keypoints.data, np.asarray(w.keypoints.data)
        assert gk.shape == wk.shape == (len(gd), 4, 3)
        np.testing.assert_allclose(gk[..., :2], wk[..., :2], rtol=0, atol=1e-3)
        np.testing.assert_allclose(gk[..., 2], wk[..., 2], rtol=0, atol=1e-6)


def test_predict_kept_anchor_indices_match_jax(pose):
    from bsyolo_tpu.kernels.postprocess import detect_postprocess as jpost

    from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess

    jm, spec, v, port = pose
    x = np.random.default_rng(3).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    _, ji = jpost(jm.apply(v, jnp.asarray(x), train=False), spec.head_strides, spec.nc, conf_thres=0.01,
                  return_idx=True)
    with torch.no_grad():
        _, pi = detect_postprocess(port.model(torch.from_numpy(nchw(x))), spec.head_strides, spec.nc,
                                   conf_thres=0.01, return_idx=True)
    assert int((np.asarray(ji) >= 0).sum()) > 20
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_results_keypoints_save_txt_and_summary_match_jax(pose, tmp_path):
    from bsyolo_tpu.engine.results import Results as JResults

    jm, spec, v, port = pose
    frame = np.random.default_rng(13).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    (r,) = port.predict(frame, imgsz=IMG, conf=0.05)
    j = JResults(frame, "f.jpg", port.names, boxes=r.boxes.data, keypoints=r.keypoints.data)
    for conf in (False, True):
        r.save_txt(tmp_path / f"p{conf}.txt", save_conf=conf)
        j.save_txt(tmp_path / f"j{conf}.txt", save_conf=conf)
        assert (tmp_path / f"p{conf}.txt").read_text() == (tmp_path / f"j{conf}.txt").read_text()
    assert r.summary() == j.summary() and r.summary(normalize=True) == j.summary(normalize=True)
    np.testing.assert_array_equal(r.keypoints.xyn, j.keypoints.xyn)
    np.testing.assert_array_equal(r.keypoints.conf, j.keypoints.conf)
    assert r[1:3].keypoints.data.shape == (2, 4, 3)


@pytest.mark.parametrize("nkpt,nd", [(4, 3), (17, 3), (5, 2)])
def test_oks_matches_jax(nkpt, nd):
    from bsyolo_tpu.losses.pose import OKS_SIGMA as JS
    from bsyolo_tpu.utils.metrics import kpt_iou_np as jiou

    from bsyolo_tpu_torch.losses.pose import OKS_SIGMA, oks_sigmas
    from bsyolo_tpu_torch.utils.metrics import kpt_iou_np

    np.testing.assert_array_equal(OKS_SIGMA, JS)
    sigma = oks_sigmas((nkpt, nd))
    np.testing.assert_array_equal(sigma, JS if (nkpt, nd) == (17, 3) else np.ones(nkpt) / nkpt)
    rng = np.random.default_rng(nkpt)
    gt = np.concatenate([rng.uniform(0, 50, (5, nkpt, 2)), (rng.uniform(0, 1, (5, nkpt, 1)) < 0.7) * 2.0], -1)
    pred = gt[rng.integers(0, 5, 7)][..., :nd] + rng.normal(0, 2, (7, nkpt, nd))
    area = rng.uniform(50, 900, 5)
    np.testing.assert_allclose(kpt_iou_np(gt, pred, area, sigma), jiou(gt, pred, area, sigma), rtol=1e-12)


def _loss_inputs(pose, size, seed=3):
    jm, spec, v, _ = pose
    batch = task_batch(seed, 2, size, 6, spec.nc, "pose")
    x = batch["img"].astype(np.float32) / 255
    jout = jm.apply(v, jnp.asarray(x), train=False)
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    pm = build_model(port_spec(POSE), "cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        pout = pm(torch.from_numpy(nchw(x)))
    return spec, batch, jout, pout


@pytest.mark.parametrize("gains", [(12.0, 1.0), (5.0, 2.0)], ids=["default", "gains"])
def test_pose_loss_and_tal_masks_match_jax(pose, gains):
    from bsyolo_tpu.losses.detect import DetectionLossConfig as JC, init_loss_state as jinit
    from bsyolo_tpu.losses.pose import pose_loss as jloss

    from bsyolo_tpu_torch.losses import DetectionLossConfig, init_loss_state, pose_loss
    from bsyolo_tpu_torch.losses.detect import detect_terms

    spec, batch, jout, pout = _loss_inputs(pose, 96)
    t = {k: torch.from_numpy(v) for k, v in batch.items() if k != "img"}
    _, want, _ = jloss(jout, *(jnp.asarray(batch[k]) for k in ("cls", "bboxes", "mask", "keypoints")), jinit(),
                       JC(nc=spec.nc, strides=spec.head_strides), kpt_shape=(4, 3), pose_gain=gains[0],
                       kobj_gain=gains[1])
    _, got, _ = pose_loss(pout, t["cls"].long(), t["bboxes"], t["mask"], t["keypoints"], init_loss_state(),
                          DetectionLossConfig(nc=spec.nc, strides=spec.head_strides), kpt_shape=(4, 3),
                          pose_gain=gains[0], kobj_gain=gains[1])
    assert got.shape == (5,) and float(got[1]) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=1e-6)
    jassign, _ = jax_assign_weight(jout, batch["cls"], batch["bboxes"], batch["mask"], spec.nc, spec.head_strides)
    terms = detect_terms(pout, t["cls"].long(), t["bboxes"], t["mask"], init_loss_state(),
                         DetectionLossConfig(nc=spec.nc, strides=spec.head_strides))
    np.testing.assert_array_equal(terms.assign.fg_mask.numpy(), jassign.fg_mask)
    np.testing.assert_array_equal(terms.assign.target_gt_idx.numpy(), jassign.target_gt_idx)


def test_sgd_step_matches_jax(pose):
    """One SGD step with the pose loss from the same weights and batch."""
    from bsyolo_tpu.engine.optim import OptimConfig as JOpt
    from bsyolo_tpu.engine.train_step import StepConfig as JStep, init_train_state as jinit, make_train_step as jmake
    from bsyolo_tpu.losses import DetectionLossConfig as JLoss
    from bsyolo_tpu.losses.pose import pose_loss as jloss

    from bsyolo_tpu_torch.engine.optim import OptimConfig
    from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
    from bsyolo_tpu_torch.losses import DetectionLossConfig
    from bsyolo_tpu_torch.nn.model import build_model
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax, train_state_to_jax
    from test_torch_train_step import _compare_states

    jm, spec, v, _ = pose
    common = dict(batch_size=2, nb=5, nw=2, use_adamw=False, weight_decay=0.0005)
    okw = dict(name="SGD", lr0=0.01, epochs=4, nbs=2, warmup_bias_lr=0.1)
    names = ("box_loss", "pose_loss", "kobj_loss", "cls_loss", "dfl_loss")

    def jcrit(outputs, batch, ls, lc):
        return jloss(outputs, batch["cls"], batch["bboxes"], batch["mask"], batch["keypoints"], ls, lc,
                     kpt_shape=(4, 3))

    jcfg = JStep(loss=JLoss(nc=spec.nc, strides=spec.head_strides), optim=JOpt(**okw), **common)
    jstep = jmake(jm, jcfg, criterion=jcrit, item_names=names)
    jstate = jinit({k: jax.tree_util.tree_map(jnp.asarray, x) for k, x in v.items()}, jcfg)
    pm = build_model(port_spec(POSE), "cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    pcfg = StepConfig(loss=DetectionLossConfig(nc=spec.nc, strides=spec.head_strides), optim=OptimConfig(**okw),
                      **common)
    criterion, item_names = task_criterion(pm.spec)
    assert item_names == names
    pstate = init_train_state(pm, pcfg)
    pstep = make_train_step(pm, pcfg, criterion, item_names)
    batch = task_batch(8, 2, 96, 6, spec.nc, "pose")
    jstate, jmet = jstep(jstate, {k: jnp.asarray(x) for k, x in batch.items()})
    want = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jstate)
    pb = port_batch(batch)
    pstate, pmet = pstep(pstate, {k: torch.as_tensor(x).long() if k == "cls" else torch.as_tensor(x)
                                  for k, x in pb.items()})
    _compare_states(train_state_to_jax(pstate, want), want)
    for k in ("loss", *names):
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)


def test_validator_metrics_match_jax(pose, tmp_path):
    """Both validators over the JAX loader's batches of a seeded keypoint dataset, fed the same
    detections and keypoints (the ground truths, jittered)."""
    from bsyolo_tpu.engine.validator import PoseValidator as JVal

    from bsyolo_tpu_torch.engine.validator import PoseValidator

    jm, spec, v, port = pose
    data = write_task_dataset(tmp_path / "ds", "pose", n_train=1, n_val=10)
    batches = jax_val_batches(data, "pose", 64)
    rng = np.random.default_rng(10)
    rows, kpts = [], []
    for b in batches:
        r = jittered_gt_rows(b, rng)
        k = np.zeros((len(r), 20, 4, 3), np.float32)
        for i in range(len(r)):
            gk = b["keypoints"][i][b["mask"][i] > 0] * [64, 64, 1]
            k[i, : len(gk)] = gk + np.concatenate([rng.normal(0, 1.5, gk[..., :2].shape),
                                                    np.zeros(gk[..., 2:].shape)], -1)
        rows.append(r)
        kpts.append(k)
    it = iter(zip(rows, kpts))
    jv = JVal(jm, spec, names={0: "a", 1: "b"})
    jv._forward = lambda variables, img: tuple(jnp.asarray(a) for a in next(it))
    want = jv(v, batches)
    it2 = iter(zip(rows, kpts))
    pv = PoseValidator(port.model, port.spec, names={0: "a", 1: "b"}, device="cpu",
                       forward_fn=lambda variables, img: tuple(torch.from_numpy(a) for a in next(it2)))
    got = pv(None, [port_batch(b) for b in batches])
    assert want.pose.map50 > 0.1
    np.testing.assert_allclose([got.pose.map50, got.pose.map, got.fitness], [want.pose.map50, want.pose.map,
                               want.fitness], rtol=0, atol=1e-6)
    assert got.results_dict.keys() == want.results_dict.keys()
    np.testing.assert_allclose([float(x) for x in got.results_dict.values()],
                               [float(x) for x in want.results_dict.values()], rtol=0, atol=1e-6)


def test_pose_json_matches_jax():
    from bsyolo_tpu.utils import coco as J

    from bsyolo_tpu_torch.utils import coco as P

    rng = np.random.default_rng(14)
    dets = np.concatenate([rng.uniform(0, 20, (4, 4)), np.array([[0.9], [0.0], [0.4], [0.6]]),
                           rng.integers(0, 3, (4, 1))], 1)
    for nd in (3, 2):
        kpts = rng.uniform(0, 50, (4, 5, nd))
        assert P.pose_pred_to_json(dets, kpts, "images/7.jpg") == J.pose_pred_to_json(dets, kpts, "images/7.jpg")


def test_classes_filter_applies_to_pose_rows(pose):
    """``predict(classes=...)`` keeps the rows of those classes, with their keypoints, for a Pose
    graph too; the JAX predictor's pose branch ignores ``classes`` (a fault not copied)."""
    from bsyolo_tpu.engine.predictor import DetectionPredictor

    jm, spec, v, port = pose
    frame = np.random.default_rng(15).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    (kept,) = port.predict(frame, imgsz=IMG, conf=0.05, classes=[0])
    (none,) = port.predict(frame, imgsz=IMG, conf=0.05, classes=[1])
    (jax_none,) = DetectionPredictor(jm, spec, v, conf=0.05, imgsz=IMG, classes=[1], names=port.names)([frame])
    assert len(kept) > 3 and len(kept.keypoints) == len(kept)
    assert len(none) == 0 and none.keypoints.data.shape == (0, 4, 3)
    assert len(jax_none) == len(kept)
