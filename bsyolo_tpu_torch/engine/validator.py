"""Validators of the detect, segment, pose and OBB tasks (counterpart of ``bsyolo_tpu/engine/validator.py``).

Each batch runs the graph and ``detect_postprocess`` on the card (one launch
of the box decode kernel per batch, then the NMS), and the host matches the
kept rows against the ground truths at 10 IoU thresholds into
``ap_per_class``. NMS runs at the reference's val settings, conf 0.001 and
IoU 0.7. An RT-DETR graph's decoder output goes through ``decode_rtdetr``
(its top queries above conf, no NMS), as in the JAX validator.

``SegmentationValidator`` adds mask mAP: the kept rows' masks are assembled on
the card at prototype size (``process_mask(upsample=False)``, thresholded at
0.5) and matched by mask IoU against the overlap-encoded ground truth (pixel
value g + 1 marks instance g). ``PoseValidator`` adds OKS keypoint mAP
(``kpt_iou_np``, areas 0.53 of the boxes', COCO's sigmas for 17 x 3
keypoints, else 1 / nkpt each). ``OBBValidator`` decodes rotated boxes
(``decode_obb``) and suppresses them by probIoU within a class
(``nms_rotated``) on the card, then matches the kept rows by probIoU
(``batch_probiou``), which the confusion matrix uses too.

Batches follow the JAX package's padded-label contract, with the image NCHW:
img (B, 3, H, W) uint8, cls (B, M), bboxes (B, M, 4) normalized xywh,
mask (B, M), masks (B, H / 4, W / 4) overlap-encoded (segment), keypoints
(B, M, nkpt, 3) normalized (pose), rboxes (B, M, 5) normalized xywhr (OBB) and, from a val loader, im_idx (B,),
negative on the rows that pad the last batch of a canvas shape. Batches may change shape from one to
the next (rect val batches).

With ``save_json`` the kept rows of every image go, in its original pixels,
into ``<save_dir>/predictions.json`` (COCO results); with ``save_txt`` into
``<save_dir>/labels/<stem>.txt`` (normalized xywh, with ``save_conf`` the
score; detect only). Both need the images' files, in the loader's order (``im_files``).
Segment results carry each mask, brought back to the original image
(``mask_to_original``), as RLE; pose results their keypoints in original
pixels; OBB results their rotated box (``rbox``, the centre shifted back by the pad, the
size scaled back, the angle kept) and its corners (``poly``).
The original size is that of the image as ``imread`` decodes it, after the
JPEG Exif orientation; the JAX package takes PIL's size, before it.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from bsyolo_tpu_torch import select_device
from bsyolo_tpu_torch.data.imread import decoded_size
from bsyolo_tpu_torch.kernels.postprocess import detect_postprocess
from bsyolo_tpu_torch.losses.pose import OKS_SIGMA
from bsyolo_tpu_torch.nn.heads import (decode_detections, decode_extras, decode_keypoints, decode_obb, gather_anchors,
                                       postprocess_e2e)
from bsyolo_tpu_torch.nn.transformer import decode_rtdetr
from bsyolo_tpu_torch.ops.boxes import xywh2xyxy
from bsyolo_tpu_torch.ops.letterbox import letterbox_params
from bsyolo_tpu_torch.ops.masks import process_mask
from bsyolo_tpu_torch.ops.normalize import normalize_image_batch
from bsyolo_tpu_torch.ops.obb import batch_probiou, nms_rotated
from bsyolo_tpu_torch.utils import LOGGER
from bsyolo_tpu_torch.utils.coco import (obb_pred_to_json, pose_pred_to_json, pred_to_json, save_predictions_json,
                                         seg_pred_to_json)
from bsyolo_tpu_torch.utils.metrics import (ConfusionMatrix, DetMetrics, Metric, _box_iou_np, ap_per_class,
                                            kpt_iou_np, match_predictions)


def _pipeline_forward(forward, variables, loader):
    """Enqueue batch k + 1's forward before batch k's result is read, so the host's
    matching of batch k overlaps the card's next forward; yields (batch, pending)."""
    prev = None
    for nxt in loader:
        pending = forward(variables, nxt["img"])
        if prev is not None:
            yield prev
        prev = (nxt, pending)
    if prev is not None:
        yield prev


def _collapse_single_cls(dets: np.ndarray) -> np.ndarray:
    """single_cls: predictions collapse to class 0; padding rows keep their -1."""
    d = dets.copy()
    d[..., 5] = np.where(d[..., 5] >= 0, 0.0, d[..., 5])
    return d


def _filter_classes(dets: np.ndarray, classes) -> np.ndarray:
    """classes=[...]: detections outside the list become padding (conf 0, cls -1)."""
    if not classes:
        return dets
    d = dets.copy()
    keep = np.isin(d[..., 5].astype(int), np.asarray(list(classes), int))
    d[..., 4] = np.where(keep, d[..., 4], 0.0)
    d[..., 5] = np.where(keep, d[..., 5], -1.0)
    return d


def unletterbox(im_file, input_hw) -> tuple:
    """((w0, h0), r, dw, dh) mapping the letterboxed input of ``input_hw`` back to ``im_file``'s
    pixels; val letterboxes centred, without enlarging."""
    h0, w0 = decoded_size(im_file)
    r, (dw, dh), _ = letterbox_params((h0, w0), input_hw, scaleup=False)
    return (w0, h0), r, dw, dh


def boxes_to_original(dets: np.ndarray, ub) -> np.ndarray:
    """Rows with xyxy mapped back to the original image's pixels by ``ub`` (``unletterbox``'s) and
    clipped to them."""
    (w0, h0), r, dw, dh = ub
    d = dets.copy()
    d[:, [0, 2]] = np.clip((d[:, [0, 2]] - dw) / r, 0, w0)
    d[:, [1, 3]] = np.clip((d[:, [1, 3]] - dh) / r, 0, h0)
    return d


def mask_to_original(mask: np.ndarray, input_hw, orig_wh, r: float, dw: float, dh: float) -> np.ndarray:
    """Binary mask at prototype size -> binary mask of the original image: repeated up to the
    network input, the letterbox padding cut off, then nearest-resized to (h0, w0)."""
    h, w = input_hw
    w0, h0 = orig_wh
    fh, fw = h // mask.shape[0], w // mask.shape[1]
    mi = np.repeat(np.repeat(mask, fh, axis=0), fw, axis=1)
    ch, cw = int(round(h0 * r)), int(round(w0 * r))
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    crop = mi[top : top + ch, left : left + cw]
    if crop.size == 0:
        return np.zeros((h0, w0), bool)
    yi = np.clip((np.arange(h0) * crop.shape[0] / h0).astype(int), 0, crop.shape[0] - 1)
    xi = np.clip((np.arange(w0) * crop.shape[1] / w0).astype(int), 0, crop.shape[1] - 1)
    return crop[yi][:, xi].astype(bool)


def save_label_txt(path: Path, dets: np.ndarray, wh, save_conf: bool) -> None:
    """One ``cls cx cy w h [conf]`` line per row, normalized by the image's (w, h)."""
    w0, h0 = wh
    lines = []
    for x1, y1, x2, y2, cf, cl in dets[:, :6]:
        parts = [str(int(cl)), f"{(x1 + x2) / 2 / w0:.6f}", f"{(y1 + y2) / 2 / h0:.6f}", f"{(x2 - x1) / w0:.6f}",
                 f"{(y2 - y1) / h0:.6f}"]
        if save_conf:
            parts.append(f"{cf:.6f}")
        lines.append(" ".join(parts))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + ("\n" if lines else ""))


class SegmentMetrics(DetMetrics):
    """Box and mask mAP; fitness is the sum of the two."""

    def __init__(self, names=None):
        super().__init__(names)
        self.seg = Metric()
        self.seg.nc = len(self.names)

    def process_seg(self, tp_m, conf, pred_cls, target_cls):
        self.seg.update(ap_per_class(tp_m, conf, pred_cls, target_cls))

    @property
    def fitness(self):
        return self.box.fitness() + self.seg.fitness()

    @property
    def results_dict(self):
        return {
            "metrics/precision(B)": self.box.mp,
            "metrics/recall(B)": self.box.mr,
            "metrics/mAP50(B)": self.box.map50,
            "metrics/mAP50-95(B)": self.box.map,
            "metrics/mAP50(M)": self.seg.map50,
            "metrics/mAP50-95(M)": self.seg.map,
            "fitness": self.fitness,
        }


class PoseMetrics(DetMetrics):
    """Box and OKS keypoint mAP; fitness is the sum of the two (``results_dict`` reports the box
    metrics and the fitness, as the JAX package's)."""

    def __init__(self, names=None):
        super().__init__(names)
        self.pose = Metric()
        self.pose.nc = len(self.names)

    def process_pose(self, tp_p, conf, pred_cls, target_cls):
        self.pose.update(ap_per_class(tp_p, conf, pred_cls, target_cls))

    @property
    def fitness(self):
        return self.box.fitness() + self.pose.fitness()


class DetectionValidator:
    extra = ()  # names of the task's own true-positive stats (mask or keypoint matches)

    def __init__(
        self,
        model: torch.nn.Module,
        spec,
        conf: float = 0.001,
        iou: float = 0.7,
        max_det: int = 300,
        pre_k: int = 1024,
        names: Optional[Dict[int, str]] = None,
        save_json: bool = False,
        save_dir=None,
        class_map=None,
        single_cls: bool = False,
        plots: bool = False,
        classes=None,
        save_txt: bool = False,
        save_conf: bool = False,
        forward_fn=None,
        device=None,
    ):
        """``device``: where the forward runs (``cuda:0`` by default; raises without a
        card); the model is expected there. ``forward_fn(variables, img)`` replaces
        the graph and postprocess: it takes the batch's image as the loader gives
        it and returns what ``_postprocess`` returns ((B, max_det, 6) rows for detect).
        ``class_map`` maps classes to the category ids of ``predictions.json``
        (``utils/coco.py COCO80_TO_COCO91``)."""
        if plots:
            raise NotImplementedError("val(plots=True) is not ported yet (ROADMAP queue 1, item 16)")
        self.save_json = save_json
        self.save_txt = save_txt
        self.save_conf = save_conf
        self.save_dir = Path(save_dir or ".")
        self.class_map = class_map
        self.model = model
        self.spec = spec
        self.device = select_device(device)
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.pre_k = pre_k
        self.names = names or {i: n for i, n in enumerate(spec.names)}
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.single_cls = single_cls
        self.classes = classes
        self._forward = forward_fn if forward_fn is not None else self._graph_forward

    @torch.inference_mode()
    def _graph_forward(self, variables: Optional[Mapping[str, torch.Tensor]], img):
        """The graph in eval mode with ``variables`` (name -> tensor) in place of the
        model's own parameters or buffers, then ``_postprocess``."""
        x = normalize_image_batch(torch.as_tensor(img).to(self.device, non_blocking=True))
        was_training = self.model.training
        self.model.eval()
        try:
            if variables:
                out = torch.func.functional_call(self.model, dict(variables), (x,), strict=False)
            else:
                out = self.model(x)
        finally:
            self.model.train(was_training)
        if isinstance(out, dict) and "dec_bboxes" in out:  # RT-DETR: the decoder's top queries, no NMS
            return decode_rtdetr(out, tuple(x.shape[2:]), conf_thres=self.conf, max_det=self.max_det)
        return self._postprocess(out)

    def _nms(self, feats, **kw):
        return detect_postprocess(
            feats, self.spec.head_strides, self.spec.nc, conf_thres=self.conf, iou_thres=self.iou,
            max_det=self.max_det, pre_k=self.pre_k, agnostic=self.single_cls, reg_max=self.spec.reg_max, **kw)

    def _postprocess(self, out):
        """The head's output -> (B, max_det, 6) rows on the device; a v10Detect head's one-to-one levels
        through ``decode_detections`` and ``postprocess_e2e``, no NMS and no conf threshold, as the JAX
        validator."""
        if isinstance(out, dict) and "one2one" in out:
            return postprocess_e2e(decode_detections(out["one2one"], self.spec.head_strides, self.spec.nc,
                                                     self.spec.reg_max), self.max_det, self.spec.nc)
        return self._nms(out)

    def _to_host(self, pending):
        """What the forward returned -> (rows as numpy, the task's per-row extras or None)."""
        return (pending.cpu().numpy() if isinstance(pending, torch.Tensor) else np.asarray(pending)), None

    def _image_extras(self, extras, i: int, keep: np.ndarray, d: np.ndarray, input_hw):
        """The task's predictions of image ``i``'s kept rows (None for detect)."""
        return None

    def _extra_tp(self, pred, d, batch, i: int, gt_cls, gt_xyxy, input_hw):
        """The task's own (n, 10) true positives of image ``i`` (none for detect)."""
        return ()

    def _extra_json(self, d, pred, im_file, input_hw):
        return pred_to_json(boxes_to_original(d, unletterbox(im_file, input_hw)), im_file, class_map=self.class_map)

    def _ground_truth(self, batch, i: int, mask: np.ndarray, input_hw) -> np.ndarray:
        """Image ``i``'s ground-truth geometry in input pixels: (n, 4) xyxy boxes."""
        h, w = input_hw
        xywh = np.asarray(batch["bboxes"][i])[mask]
        return xywh2xyxy(torch.as_tensor(xywh)).numpy() * np.array([w, h, w, h], np.float32)

    def _iou(self, gt: np.ndarray, d: np.ndarray) -> np.ndarray:
        """(n_gt, n_rows) overlaps of the ground truths and the kept rows."""
        return _box_iou_np(gt, d[:, :4])

    def _confuse(self, confusion: ConfusionMatrix, d: np.ndarray, gt: np.ndarray, gt_cls: np.ndarray, iou) -> None:
        confusion.process_batch(d, gt, gt_cls)

    def _metrics(self) -> DetMetrics:
        return DetMetrics(names=self.names)

    def __call__(self, variables: Optional[Mapping[str, torch.Tensor]], loader, verbose: bool = True,
                 im_files: Optional[Sequence[str]] = None) -> DetMetrics:
        """Evaluate over ``loader``'s batches. ``variables`` overrides the model's tensors
        by name for this evaluation: the training loop passes its EMA parameters and
        the model keeps its live BatchNorm statistics; None evaluates the model as it is.
        ``im_files``: the images in the loader's order (by default its dataset's
        ``img_files``), for ``save_json`` and ``save_txt``."""
        if im_files is None:
            im_files = getattr(getattr(loader, "dataset", None), "img_files", None)
        write = (self.save_json or self.save_txt) and bool(im_files)
        if (self.save_json or self.save_txt) and not write:
            LOGGER.warning("save_json/save_txt need the images' files (im_files); nothing will be written")
        jdict: list = []
        keys = ("tp", *self.extra)
        stats = {k: [] for k in (*keys, "conf", "pred_cls", "target_cls")}
        confusion = ConfusionMatrix(nc=self.spec.nc, conf=self.conf)
        t_infer = 0.0
        n_img = 0
        for batch, pending in _pipeline_forward(self._forward, variables, loader):
            t0 = time.perf_counter()
            dets, extras = self._to_host(pending)
            t_infer += time.perf_counter() - t0
            if self.single_cls:
                dets = _collapse_single_cls(dets)
            dets = _filter_classes(dets, self.classes)
            b, h, w = batch["img"].shape[0], batch["img"].shape[2], batch["img"].shape[3]
            n_img += b
            im_idx = batch.get("im_idx")
            for i in range(b):
                k = int(im_idx[i]) if im_idx is not None else n_img - b + i
                if k < 0:
                    continue  # a row that pads the last batch of its shape
                mask = np.asarray(batch["mask"][i]) > 0
                gt_cls = np.asarray(batch["cls"][i])[mask].astype(np.float32)
                gt = self._ground_truth(batch, i, mask, (h, w))
                keep = np.flatnonzero(dets[i][:, 4] > 0)
                d = dets[i][keep]
                pred = self._image_extras(extras, i, keep, d, (h, w))
                if write and k < len(im_files):
                    if self.save_json:
                        jdict.extend(self._extra_json(d, pred, im_files[k], (h, w)))
                    if self.save_txt:
                        ub = unletterbox(im_files[k], (h, w))
                        save_label_txt(self.save_dir / "labels" / f"{Path(im_files[k]).stem}.txt",
                                       boxes_to_original(d, ub), ub[0], self.save_conf)
                if len(d) == 0:
                    if len(gt_cls):
                        for key in keys:
                            stats[key].append(np.zeros((0, len(self.iouv)), bool))
                        stats["conf"].append(np.zeros(0))
                        stats["pred_cls"].append(np.zeros(0))
                        stats["target_cls"].append(gt_cls)
                        confusion.process_batch(None, gt, gt_cls)
                    continue
                iou = self._iou(gt, d)
                stats["tp"].append(match_predictions(d[:, 5], gt_cls, iou, self.iouv))
                for key, tp in zip(self.extra, self._extra_tp(pred, d, batch, i, gt_cls, gt, (h, w))):
                    stats[key].append(tp)
                stats["conf"].append(d[:, 4])
                stats["pred_cls"].append(d[:, 5])
                stats["target_cls"].append(gt_cls)
                self._confuse(confusion, d, gt, gt_cls, iou)
        if write and self.save_json:
            out = self.save_dir / "predictions.json"
            out.parent.mkdir(parents=True, exist_ok=True)
            save_predictions_json(jdict, out)
            LOGGER.info(f"saved {len(jdict)} COCO-format predictions to {out}")

        metrics = self._metrics()
        if stats["tp"]:
            target_cls = np.concatenate(stats["target_cls"])
            if len(target_cls):
                conf, pcls = np.concatenate(stats["conf"]), np.concatenate(stats["pred_cls"])
                metrics.process(np.concatenate(stats["tp"]), conf, pcls, target_cls)
                for key in self.extra:
                    getattr(metrics, {"tp_m": "process_seg", "tp_p": "process_pose"}[key])(
                        np.concatenate(stats[key]), conf, pcls, target_cls)
        # the time spent waiting for each batch's rows, not the device's time: the
        # next batch's forward is already enqueued while this one is matched
        metrics.speed["inference"] = t_infer / max(n_img, 1) * 1000
        metrics.confusion_matrix = confusion
        return metrics


class SegmentationValidator(DetectionValidator):
    """Box and mask mAP of a Segment graph; the mask true positives come from the mask IoU of
    each kept row's prototype-size mask against the overlap-encoded ground truth."""

    extra = ("tp_m",)

    def _postprocess(self, out):
        """-> (B, max_det, 6) rows, their (B, max_det, nm) coefficients (0 on padding rows) and the
        (B, nm, Hm, Wm) prototypes, on the device."""
        dets, idx = self._nms(out["feats"], return_idx=True)
        return dets, gather_anchors(decode_extras(out["feats"], self.spec.nc, self.spec.reg_max), idx), out["proto"]

    def _to_host(self, pending):
        dets, coeffs, proto = pending
        return dets.cpu().numpy(), (coeffs, proto)

    def _image_extras(self, extras, i, keep, d, input_hw):
        """The kept rows' binary masks at prototype size, assembled on the device."""
        coeffs, proto = extras
        k = torch.from_numpy(keep).to(coeffs.device)
        boxes = torch.from_numpy(np.ascontiguousarray(d[:, :4])).to(coeffs.device)
        return (process_mask(proto[i], coeffs[i][k], boxes, input_hw, upsample=False) > 0.5).cpu().numpy()

    def _extra_tp(self, pred, d, batch, i, gt_cls, gt_xyxy, input_hw):
        gmask = np.asarray(batch["masks"][i])  # (hm, wm) overlap-encoded
        n_gt = len(gt_cls)
        g_flat = np.stack([(gmask == g + 1) for g in range(n_gt)]).reshape(n_gt, -1).astype(np.float32) if n_gt \
            else np.zeros((0, gmask.size), np.float32)
        p_flat = pred.reshape(len(pred), -1).astype(np.float32)
        inter = g_flat @ p_flat.T
        union = g_flat.sum(-1)[:, None] + p_flat.sum(-1)[None, :] - inter
        return (match_predictions(d[:, 5], gt_cls, inter / (union + 1e-7), self.iouv),)

    def _extra_json(self, d, pred, im_file, input_hw):
        if not len(d):
            return []
        ub = unletterbox(im_file, input_hw)
        m0 = np.stack([mask_to_original(m, input_hw, *ub) for m in pred])
        return seg_pred_to_json(boxes_to_original(d, ub), m0, im_file, class_map=self.class_map)

    def _metrics(self):
        return SegmentMetrics(names=self.names)


class PoseValidator(DetectionValidator):
    """Box and OKS keypoint mAP of a Pose graph."""

    extra = ("tp_p",)

    def __init__(self, model, spec, **kwargs):
        super().__init__(model, spec, **kwargs)
        nkpt, nd = spec.kpt_shape
        self.sigma = OKS_SIGMA if (nkpt == 17 and nd == 3) else np.ones(nkpt) / nkpt

    def _postprocess(self, feats):
        """-> (B, max_det, 6) rows and their (B, max_det, nkpt, ndim) keypoints in input pixels
        (0 on padding rows), on the device."""
        dets, idx = self._nms(feats, return_idx=True)
        kpts = decode_keypoints(decode_extras(feats, self.spec.nc, self.spec.reg_max), feats, self.spec.head_strides,
                                self.spec.kpt_shape)
        return dets, gather_anchors(kpts, idx)

    def _to_host(self, pending):
        return pending[0].cpu().numpy(), pending[1].cpu().numpy()

    def _image_extras(self, extras, i, keep, d, input_hw):
        return extras[i][keep]

    def _extra_tp(self, pred, d, batch, i, gt_cls, gt_xyxy, input_hw):
        h, w = input_hw
        gt_kpts = np.asarray(batch["keypoints"][i])[np.asarray(batch["mask"][i]) > 0].copy()
        gt_kpts[..., 0] *= w
        gt_kpts[..., 1] *= h
        area = (gt_xyxy[:, 2] - gt_xyxy[:, 0]) * (gt_xyxy[:, 3] - gt_xyxy[:, 1]) * 0.53
        return (match_predictions(d[:, 5], gt_cls, kpt_iou_np(gt_kpts, pred, area, self.sigma), self.iouv),)

    def _extra_json(self, d, pred, im_file, input_hw):
        if not len(d):
            return []
        (w0, h0), r, dw, dh = ub = unletterbox(im_file, input_hw)
        d0 = boxes_to_original(d, ub)
        k0 = pred.copy()
        k0[..., 0] = np.clip((k0[..., 0] - dw) / r, 0, w0)
        k0[..., 1] = np.clip((k0[..., 1] - dh) / r, 0, h0)
        return pose_pred_to_json(d0, k0, im_file, class_map=self.class_map)

    def _metrics(self):
        return PoseMetrics(names=self.names)


class OBBValidator(DetectionValidator):
    """Rotated-box mAP of an OBB graph: rows matched by probIoU at 10 thresholds, the confusion matrix on
    probIoU too. NMS has no agnostic mode here, as in the JAX package: with ``single_cls`` the classes
    collapse after the class-wise suppression. ``save_txt`` is not written (detect only, as in the JAX
    package)."""

    def _postprocess(self, feats):
        """-> (B, min(max_det, 512, A), 7) rows x, y, w, h, conf, cls, angle on the device."""
        preds = decode_obb(feats, self.spec.head_strides, self.spec.nc, self.spec.reg_max)
        return nms_rotated(preds, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det, nc=self.spec.nc)

    def _ground_truth(self, batch, i, mask, input_hw):
        """(n, 5) xywhr rotated boxes in input pixels."""
        h, w = input_hw
        return np.asarray(batch["rboxes"][i])[mask] * np.array([w, h, w, h, 1.0], np.float32)

    def _iou(self, gt, d):
        return batch_probiou(torch.from_numpy(gt), torch.from_numpy(np.concatenate([d[:, :4], d[:, 6:7]], -1))
                             ).numpy()

    def _confuse(self, confusion, d, gt, gt_cls, iou):
        keep = d[:, 4] > confusion.conf
        confusion.process_batch(d[keep], gt, gt_cls, iou=iou[:, keep])

    def _extra_json(self, d, pred, im_file, input_hw):
        """The rows' centres shifted back by the pad and sizes scaled back to the original image, the
        angle kept."""
        _, r, dw, dh = unletterbox(im_file, input_hw)
        d0 = d.copy()
        d0[:, 0] = (d0[:, 0] - dw) / r
        d0[:, 1] = (d0[:, 1] - dh) / r
        d0[:, 2:4] /= r
        return obb_pred_to_json(d0, im_file, class_map=self.class_map)
