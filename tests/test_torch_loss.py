"""The port's loss path (ops.boxes IoU family, bbox2dist, normalize, losses.tal,
losses.detect) against bsyolo_tpu, on the same numpy inputs from one seed.

Gates: box ops elementwise within rtol 1e-5 / atol 1e-6; the TAL masks and
indices identical (ties, empty rows and padding included), its target boxes
and scores within atol 1e-5; the detection loss's total and items and the
LossState after 3 calls within rtol 1e-4, NWD on and off, on seeded
yolo11n-shaped head levels (nc 12, three levels at imgsz 256, no graph).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

import jax
import jax.numpy as jnp
import torch

from torch_port import nchw

FLAGS = ["plain", "GIoU", "DIoU", "CIoU", "SIoU", "MDPIoU"]


def _xyxy(rng, n, lo=0.0, hi=200.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(1, 60, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _pair(rng, n, xywh):
    a, b = _xyxy(rng, n), _xyxy(rng, n)
    b[: n // 3] = a[: n // 3] + rng.normal(0, 3, (n // 3, 4)).astype(np.float32)  # overlapping pairs
    if xywh:
        a = np.concatenate([(a[:, :2] + a[:, 2:]) / 2, np.abs(a[:, 2:] - a[:, :2]) + 1], -1)
        b = np.concatenate([(b[:, :2] + b[:, 2:]) / 2, np.abs(b[:, 2:] - b[:, :2]) + 1], -1)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("xywh", [True, False], ids=["xywh", "xyxy"])
@pytest.mark.parametrize("inner", [False, True], ids=["iou", "inner"])
@pytest.mark.parametrize("flag", FLAGS)
def test_bbox_iou_matches_jax(flag, inner, xywh):
    from bsyolo_tpu.ops.boxes import bbox_iou as jax_iou
    from bsyolo_tpu_torch.ops.boxes import bbox_iou

    a, b = _pair(np.random.default_rng(FLAGS.index(flag) * 4 + 2 * inner + xywh), 300, xywh)
    kw = {} if flag == "plain" else {flag: True}
    kw.update(xywh=xywh, Inner_iou=inner, feat_h=320.0, feat_w=256.0)
    got = bbox_iou(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy()
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b), **kw))
    assert got.shape == want.shape == (300, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ciou_gradient_matches_jax():
    """CIoU's alpha carries no gradient in either package."""
    from bsyolo_tpu.ops.boxes import bbox_iou as jax_iou
    from bsyolo_tpu_torch.ops.boxes import bbox_iou

    a, b = _pair(np.random.default_rng(40), 64, False)
    want = np.asarray(jax.grad(lambda x: jax_iou(x, jnp.asarray(b), xywh=False, CIoU=True).sum())(jnp.asarray(a)))
    x = torch.from_numpy(a).requires_grad_()
    bbox_iou(x, torch.from_numpy(b), xywh=False, CIoU=True).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_inner_iou_wasserstein_and_bbox2dist_match_jax():
    from bsyolo_tpu.ops import anchors as JA
    from bsyolo_tpu.ops import boxes as JB
    from bsyolo_tpu_torch.ops import anchors as PA
    from bsyolo_tpu_torch.ops import boxes as PB

    rng = np.random.default_rng(41)
    a, b = _pair(rng, 200, False)
    for xywh in (False, True):
        np.testing.assert_allclose(PB.inner_iou(torch.from_numpy(a), torch.from_numpy(b), xywh=xywh, ratio=0.8).numpy(),
                                   np.asarray(JB.inner_iou(jnp.asarray(a), jnp.asarray(b), xywh=xywh, ratio=0.8)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(PB.wasserstein_loss(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(JB.wasserstein_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-6)
    pts = rng.uniform(0, 200, (200, 2)).astype(np.float32)
    np.testing.assert_allclose(PA.bbox2dist(torch.from_numpy(pts), torch.from_numpy(a), 15).numpy(),
                               np.asarray(JA.bbox2dist(jnp.asarray(pts), jnp.asarray(a), 15)), rtol=1e-5, atol=1e-6)


def test_normalize_image_batch_matches_jax():
    from bsyolo_tpu.ops.normalize import normalize_image_batch as jnorm
    from bsyolo_tpu_torch.ops.normalize import normalize_image_batch

    u8 = np.random.default_rng(42).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = normalize_image_batch(torch.from_numpy(nchw(u8)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), nchw(np.asarray(jnorm(jnp.asarray(u8)))), rtol=1e-5, atol=1e-6)
    f = torch.rand(1, 3, 4, 4)
    assert normalize_image_batch(f) is f  # float passes through


# --- task-aligned assignment -------------------------------------------------


def _assign_inputs(seed, b=3, sizes=((16, 16), (8, 8)), strides=(8, 16), nc=4, M=6):
    """Seeded assigner inputs: predictions near some ground truths, a duplicated ground
    truth (same box and label twice), an image with no ground truth, padded rows."""
    from bsyolo_tpu_torch.ops.anchors import make_anchors

    rng = np.random.default_rng(seed)
    anchors, stride_t = make_anchors(sizes, strides)
    anc = (anchors * stride_t).numpy()
    A = len(anc)
    imgsz = sizes[0][0] * strides[0]
    gt = np.zeros((b, M, 4), np.float32)
    labels = rng.integers(0, nc, (b, M)).astype(np.int32)
    mask = np.zeros((b, M), np.float32)
    for i in range(b - 1):  # the last image has no ground truth
        n = M - 1 - i
        xy = rng.uniform(0, imgsz * 0.7, (n, 2))
        wh = rng.uniform(imgsz * 0.1, imgsz * 0.3, (n, 2))
        gt[i, :n] = np.concatenate([xy, xy + wh], -1)
        mask[i, :n] = 1
    gt[0, 1], labels[0, 1] = gt[0, 0], labels[0, 0]  # duplicated ground truth
    centre = np.concatenate([anc, anc], -1)
    pd_bboxes = (centre + rng.uniform(-20, 20, (b, A, 4)) * np.array([1, 1, -1, -1]) - np.array([8, 8, -8, -8]))
    scores = 1 / (1 + np.exp(-rng.normal(0, 2, (b, A, nc))))
    return (scores.astype(np.float32), pd_bboxes.astype(np.float32), anc.astype(np.float32), labels, gt, mask)


def _assign_both(inputs, topk, nc):
    from bsyolo_tpu.losses.tal import task_aligned_assign as jassign
    from bsyolo_tpu_torch.losses.tal import task_aligned_assign

    want = jassign(*[jnp.asarray(x) for x in inputs], topk=topk, num_classes=nc)
    got = task_aligned_assign(*[torch.from_numpy(np.asarray(x)) for x in inputs], topk=topk, num_classes=nc)
    return got, want


def _assert_assign_equal(got, want):
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(want.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(want.target_labels))
    np.testing.assert_allclose(got.target_bboxes.numpy(), np.asarray(want.target_bboxes), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores), rtol=0, atol=1e-5)


@pytest.mark.parametrize("topk", [1, 3, 10])
def test_assigner_matches_jax(topk):
    inputs = _assign_inputs(topk)
    got, want = _assign_both(inputs, topk, 4)
    fg = got.fg_mask.numpy()
    assert fg[:-1].any() and not fg[-1].any()  # assignments made; none in the image without ground truth
    _assert_assign_equal(got, want)


def test_assigner_keeps_every_tied_anchor():
    """Equal metrics at the k-th value: the threshold keeps every tied anchor, as the
    JAX package does, where torch.topk would keep exactly k."""
    scores, pd_bboxes, anc, labels, gt, mask = _assign_inputs(7, b=2)
    gt[0, 0] = [30, 30, 90, 90]
    pd_bboxes[0] = [40, 40, 80, 80]  # every anchor predicts the same box with the same scores
    scores[0] = 0.6
    got, want = _assign_both((scores, pd_bboxes, anc, labels, gt, mask), 3, 4)
    _assert_assign_equal(got, want)
    # anchors inside ground truth 0 and claimed by no other one: all tied, all kept
    only0 = got.target_gt_idx[0] == 0
    assert int((got.fg_mask[0] & only0).sum()) > 3


def test_kth_largest_counts_distinct_values():
    from bsyolo_tpu.losses.tal import _kth_largest as jkth
    from bsyolo_tpu_torch.losses.tal import _kth_largest

    x = np.array([[5, 5, 5, 3, 3, 1, 0, 0], [2, 2, 2, 2, 0, 0, 0, 0], [0] * 8], np.float32)
    for k in (1, 2, 3, 4):
        got = _kth_largest(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, np.asarray(jkth(jnp.asarray(x), k)))
    assert _kth_largest(torch.from_numpy(x), 2)[0, 0] == 3  # torch.topk would give 5
    assert _kth_largest(torch.from_numpy(x), 3)[1, 0] == -np.inf  # fewer distinct values than k


# --- detection loss ----------------------------------------------------------

NC, IMG, STRIDES = 12, 256, (8, 16, 32)


def _loss_inputs(seed, b=2, M=4):
    """yolo11n-shaped head levels (NHWC, JAX layout) and padded ground truths."""
    rng = np.random.default_rng(seed)
    levels = [rng.normal(0, 2, (b, IMG // s, IMG // s, 64 + NC)).astype(np.float32) for s in STRIDES]
    cls = rng.integers(0, NC, (b, M)).astype(np.int32)
    xy = rng.uniform(0.2, 0.8, (b, M, 2))
    wh = rng.uniform(0.05, 0.4, (b, M, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.ones((b, M), np.float32)
    mask[0, 2:] = 0  # padding
    boxes[0, 2:] = 0
    return levels, cls, boxes, mask


@pytest.mark.parametrize("nwd", [True, False], ids=["nwd", "ciou"])
def test_detection_loss_and_state_match_jax_over_3_calls(nwd):
    from bsyolo_tpu.losses.detect import DetectionLossConfig as JCfg, detection_loss as jloss, init_loss_state as jinit
    from bsyolo_tpu_torch.losses.detect import DetectionLossConfig, detection_loss, init_loss_state

    jcfg = JCfg(nc=NC, strides=STRIDES, nwd_loss=nwd)
    cfg = DetectionLossConfig(nc=NC, strides=STRIDES, nwd_loss=nwd)
    js, ps = jinit(), init_loss_state()
    for call in range(3):
        levels, cls, boxes, mask = _loss_inputs(100 + call)
        wt, wi, js = jloss([jnp.asarray(f) for f in levels], jnp.asarray(cls), jnp.asarray(boxes),
                           jnp.asarray(mask), js, jcfg)
        feats = [torch.from_numpy(nchw(f)).requires_grad_() for f in levels]
        gt, gi, ps = detection_loss(feats, torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(mask),
                                    ps, cfg)
        assert (np.asarray(wi) > 0).all()
        np.testing.assert_allclose(gt.item(), float(wt), rtol=1e-4)
        np.testing.assert_allclose(gi.detach().numpy(), np.asarray(wi), rtol=1e-4)
        assert int(ps.updates) == int(js.updates) == call + 1
        np.testing.assert_allclose(ps.iou_mean.item(), float(js.iou_mean), rtol=1e-4)
        assert ps.iou_mean.dtype == torch.float32 and ps.updates.dtype == torch.int32


def test_detection_loss_gradient_matches_jax():
    """The loss's gradient with respect to the head maps (the assigner carries none)."""
    from bsyolo_tpu.losses.detect import DetectionLossConfig as JCfg, detection_loss as jloss, init_loss_state as jinit
    from bsyolo_tpu_torch.losses.detect import DetectionLossConfig, detection_loss, init_loss_state

    levels, cls, boxes, mask = _loss_inputs(200)
    jcfg = JCfg(nc=NC, strides=STRIDES)
    jgrads = jax.grad(lambda fs: jloss(fs, jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), jinit(), jcfg)[0])(
        [jnp.asarray(f) for f in levels])
    feats = [torch.from_numpy(nchw(f)).requires_grad_() for f in levels]
    total, _, _ = detection_loss(feats, torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(mask),
                                 init_loss_state(), DetectionLossConfig(nc=NC, strides=STRIDES))
    total.backward()
    for f, g in zip(feats, jgrads):
        want = nchw(np.asarray(g))
        np.testing.assert_allclose(f.grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_loss_with_no_ground_truth_has_only_a_class_term():
    from bsyolo_tpu_torch.losses.detect import DetectionLossConfig, detection_loss, init_loss_state

    levels, cls, boxes, mask = _loss_inputs(300)
    total, items, _ = detection_loss([torch.from_numpy(nchw(f)) for f in levels], torch.from_numpy(cls),
                                     torch.zeros_like(torch.from_numpy(boxes)), torch.zeros_like(torch.from_numpy(mask)),
                                     init_loss_state(), DetectionLossConfig(nc=NC, strides=STRIDES))
    assert items[0] == 0 and items[2] == 0 and items[1] > 0 and torch.isfinite(total)
