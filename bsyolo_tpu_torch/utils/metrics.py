"""Detection metrics: AP/mAP, the confusion matrix and prediction matching
(the port's own copy of the detect parts of ``bsyolo_tpu/utils/metrics.py``).

NumPy on the host: metric accumulation is ragged and runs once per
evaluation; the detections come from the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing (reference metrics.py smooth)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall, precision) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP (reference metrics.py:588-617)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") else np.trapz(
        np.interp(x, mrec, mpre), x
    )
    return ap, mpre, mrec


def ap_per_class(
    tp: np.ndarray,  # (N, T) bool, T IoU thresholds
    conf: np.ndarray,  # (N,)
    pred_cls: np.ndarray,  # (N,)
    target_cls: np.ndarray,  # (M,)
    eps: float = 1e-16,
):
    """Per-class AP (reference metrics.py:620-707). Returns the reference's
    tuple: (tp, fp, p, r, f1, ap, unique_classes, p_curve, r_curve, f1_curve,
    x, prec_values)."""
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    x, prec_values = np.linspace(0, 1, 1000), []
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        m = pred_cls == c
        n_l = nt[ci]
        n_p = m.sum()
        if n_p == 0 or n_l == 0:
            # keep prec_values rows 1:1 with unique_classes: a class with
            # ground truths but zero predictions gets a zero PR curve, so
            # PR_curve.png legends (indexed by ap_class_index) stay aligned
            prec_values.append(np.zeros_like(x))
            continue
        fpc = (1 - tp[m]).cumsum(0)
        tpc = tp[m].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-x, -conf[m], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-x, -conf[m], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                prec_values.append(np.interp(x, mrec, mpre))

    prec_values = np.array(prec_values) if prec_values else np.zeros((0, 1000))
    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax() if nc else 0
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return (
        tp_count,
        fp_count,
        p,
        r,
        f1,
        ap,
        unique_classes.astype(int),
        p_curve,
        r_curve,
        f1_curve,
        x,
        prec_values,
    )


def match_predictions(
    pred_classes: np.ndarray,  # (N,)
    true_classes: np.ndarray,  # (M,)
    iou: np.ndarray,  # (M, N) gt x pred
    iouv: np.ndarray,  # (T,) thresholds
) -> np.ndarray:
    """Greedy unique matching at each IoU threshold (validator.py:222-262)."""
    correct = np.zeros((pred_classes.shape[0], iouv.shape[0]), dtype=bool)
    correct_class = true_classes[:, None] == pred_classes[None, :]
    iou = iou * correct_class
    for i, threshold in enumerate(iouv.tolist()):
        matches = np.nonzero(iou >= threshold)
        matches = np.array(matches).T
        if matches.shape[0]:
            if matches.shape[0] > 1:
                matches = matches[iou[matches[:, 0], matches[:, 1]].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


class Metric:
    """Holder for per-class AP results (reference metrics.py Metric)."""

    def __init__(self):
        self.p: np.ndarray = np.array([])
        self.r: np.ndarray = np.array([])
        self.f1: np.ndarray = np.array([])
        self.all_ap: np.ndarray = np.zeros((0, 10))
        self.ap_class_index: np.ndarray = np.array([])
        self.nc = 0

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return self.p.mean() if len(self.p) else 0.0

    @property
    def mr(self):
        return self.r.mean() if len(self.r) else 0.0

    @property
    def map50(self):
        return self.all_ap[:, 0].mean() if len(self.all_ap) else 0.0

    @property
    def map75(self):
        return self.all_ap[:, 5].mean() if len(self.all_ap) else 0.0

    @property
    def map(self):
        return self.all_ap.mean() if len(self.all_ap) else 0.0

    def mean_results(self):
        return [self.mp, self.mr, self.map50, self.map]

    def class_result(self, i):
        return self.p[i], self.r[i], self.ap50[i], self.ap[i]

    @property
    def maps(self):
        """Per-class mAP array of length nc."""
        maps = np.zeros(self.nc) + self.map
        for i, c in enumerate(self.ap_class_index):
            maps[int(c)] = self.ap[i]
        return maps

    def fitness(self):
        """0.1*mAP50 + 0.9*mAP50-95 (reference metrics.py Metric.fitness)."""
        w = np.array([0.0, 0.0, 0.1, 0.9])
        return float((np.array(self.mean_results()) * w).sum())

    def update(self, results):
        (_, _, self.p, self.r, self.f1, self.all_ap, self.ap_class_index, *_rest) = results


class DetMetrics:
    """Detection metric aggregator (reference metrics.py:881-980)."""

    def __init__(self, names: Optional[Dict[int, str]] = None):
        self.names = names or {}
        self.box = Metric()
        self.box.nc = len(self.names)
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}

    def process(self, tp, conf, pred_cls, target_cls):
        results = ap_per_class(tp, conf, pred_cls, target_cls)
        self.box.nc = len(self.names)
        self.box.update(results)
        # full curves for plotting (reference plot_pr_curve/plot_mc_curve
        # inputs): x grid, per-class precision@recall, P/R/F1 vs confidence
        (_, _, _, _, _, _, _, p_curve, r_curve, f1_curve, x, prec_values) = results
        self.curves = {"x": x, "prec_values": np.asarray(prec_values),
                       "p": p_curve, "r": r_curve, "f1": f1_curve}

    @property
    def keys(self):
        return [
            "metrics/precision(B)",
            "metrics/recall(B)",
            "metrics/mAP50(B)",
            "metrics/mAP50-95(B)",
        ]

    def mean_results(self):
        return self.box.mean_results()

    @property
    def maps(self):
        return self.box.maps

    @property
    def fitness(self):
        return self.box.fitness()

    @property
    def results_dict(self):
        return dict(zip(self.keys + ["fitness"], self.mean_results() + [self.fitness]))


class ConfusionMatrix:
    """Detection confusion matrix (reference metrics.py:377-500)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = 0.25 if conf in {None, 0.001} else conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1))

    def process_batch(self, detections: Optional[np.ndarray], gt_bboxes: np.ndarray,
                      gt_cls: np.ndarray, iou: Optional[np.ndarray] = None):
        """detections: (N, 6) [x1,y1,x2,y2,conf,cls]; gt xyxy + cls.

        Pass `iou` (gt x det) to override the internal axis-aligned IoU —
        the rotated-box validator supplies probIoU (reference OBB confusion);
        the caller must then pre-filter detections to conf > self.conf."""
        if gt_cls.size == 0:
            if detections is not None:
                detections = detections[detections[:, 4] > self.conf]
                for dc in detections[:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positives
            return
        if detections is None or len(detections) == 0:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return

        if iou is None:
            detections = detections[detections[:, 4] > self.conf]
            iou = _box_iou_np(gt_bboxes, detections[:, :4])
        gt_classes = gt_cls.astype(int)
        detection_classes = detections[:, 5].astype(int)

        x = np.where(iou > self.iou_thres)
        if x[0].shape[0]:
            matches = np.concatenate((np.stack(x, 1), iou[x][:, None]), 1)
            if x[0].shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and sum(j) == 1:
                self.matrix[detection_classes[m1[j]][0], gc] += 1  # correct
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        for i, dc in enumerate(detection_classes):
            if not (n and (m1 == i).any()):
                self.matrix[dc, self.nc] += 1  # background FP


def kpt_iou_np(kpt1: np.ndarray, kpt2: np.ndarray, area: np.ndarray, sigma, eps: float = 1e-7) -> np.ndarray:
    """Object keypoint similarity: ground truths (N, K, 3), predictions (M, K, 2 or 3), gt areas
    (N,), per-keypoint sigmas (K,) -> (N, M), over the keypoints labelled in the ground truth."""
    d = (kpt1[:, None, :, 0] - kpt2[None, :, :, 0]) ** 2 + (kpt1[:, None, :, 1] - kpt2[None, :, :, 1]) ** 2
    sigma = np.asarray(sigma, np.float32)
    kpt_mask = kpt1[..., 2] != 0  # (N, K)
    e = d / ((2 * sigma) ** 2 * (area[:, None, None] + eps) * 2)
    return (np.exp(-e) * kpt_mask[:, None]).sum(-1) / (kpt_mask.sum(-1)[:, None] + eps)


def _box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) plain IoU, host-side."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(2)
    area1 = (a2 - a1).prod(2)
    area2 = (b2 - b1).prod(2)
    return inter / (area1 + area2 - inter + eps)
