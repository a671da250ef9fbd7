"""Detection validator (counterpart of the detect branch of ``bsyolo_tpu/engine/validator.py``).

Each batch runs the graph and ``detect_postprocess`` on the card (one launch
of the box decode kernel per batch, then the NMS), and the host matches the
kept rows against the ground truths at 10 IoU thresholds into
``ap_per_class``. NMS runs at the reference's val settings, conf 0.001 and
IoU 0.7.

Batches follow the JAX package's padded-label contract, with the image NCHW:
img (B, 3, H, W) uint8, cls (B, M), bboxes (B, M, 4) normalized xywh,
mask (B, M) and, from a val loader, im_idx (B,), negative on the rows that
pad the last batch of a canvas shape. Batches may change shape from one to
the next (rect val batches).

With ``save_json`` the kept rows of every image go, in its original pixels,
into ``<save_dir>/predictions.json`` (COCO results); with ``save_txt`` into
``<save_dir>/labels/<stem>.txt`` (normalized xywh, with ``save_conf`` the
score). Both need the images' files, in the loader's order (``im_files``).
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
from bsyolo_tpu_torch.ops.boxes import xywh2xyxy
from bsyolo_tpu_torch.ops.letterbox import letterbox_params
from bsyolo_tpu_torch.ops.normalize import normalize_image_batch
from bsyolo_tpu_torch.utils import LOGGER
from bsyolo_tpu_torch.utils.coco import pred_to_json, save_predictions_json
from bsyolo_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics, _box_iou_np, match_predictions


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


def boxes_to_original(dets: np.ndarray, im_file, input_hw) -> tuple:
    """(rows with xyxy mapped from the letterboxed input of ``input_hw`` back to ``im_file``'s
    pixels and clipped to them, (w0, h0)); val letterboxes centred, without enlarging."""
    h0, w0 = decoded_size(im_file)
    r, (dw, dh), _ = letterbox_params((h0, w0), input_hw, scaleup=False)
    d = dets.copy()
    d[:, [0, 2]] = np.clip((d[:, [0, 2]] - dw) / r, 0, w0)
    d[:, [1, 3]] = np.clip((d[:, [1, 3]] - dh) / r, 0, h0)
    return d, (w0, h0)


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


class DetectionValidator:
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
        it and returns (B, max_det, 6) rows. ``class_map`` maps classes to the
        category ids of ``predictions.json`` (``utils/coco.py COCO80_TO_COCO91``)."""
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
    def _graph_forward(self, variables: Optional[Mapping[str, torch.Tensor]], img) -> torch.Tensor:
        """The graph in eval mode with ``variables`` (name -> tensor) in place of the
        model's own parameters or buffers, then ``detect_postprocess``."""
        x = normalize_image_batch(torch.as_tensor(img).to(self.device, non_blocking=True))
        was_training = self.model.training
        self.model.eval()
        try:
            if variables:
                feats = torch.func.functional_call(self.model, dict(variables), (x,), strict=False)
            else:
                feats = self.model(x)
        finally:
            self.model.train(was_training)
        return detect_postprocess(
            feats, self.spec.head_strides, self.spec.nc, conf_thres=self.conf, iou_thres=self.iou,
            max_det=self.max_det, pre_k=self.pre_k, agnostic=self.single_cls, reg_max=self.spec.reg_max,
        )

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
        stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        confusion = ConfusionMatrix(nc=self.spec.nc, conf=self.conf)
        t_infer = 0.0
        n_img = 0
        for batch, pending in _pipeline_forward(self._forward, variables, loader):
            t0 = time.perf_counter()
            dets = pending.cpu().numpy() if isinstance(pending, torch.Tensor) else np.asarray(pending)
            t_infer += time.perf_counter() - t0
            if self.single_cls:
                dets = _collapse_single_cls(dets)
            dets = _filter_classes(dets, self.classes)
            b, h, w = batch["img"].shape[0], batch["img"].shape[2], batch["img"].shape[3]
            n_img += b
            scale = np.array([w, h, w, h], np.float32)
            im_idx = batch.get("im_idx")
            for i in range(b):
                if im_idx is not None and int(im_idx[i]) < 0:
                    continue  # a row that pads the last batch of its shape
                mask = np.asarray(batch["mask"][i]) > 0
                gt_cls = np.asarray(batch["cls"][i])[mask].astype(np.float32)
                gt_xyxy = xywh2xyxy(torch.as_tensor(np.asarray(batch["bboxes"][i])[mask])).numpy() * scale
                d = dets[i]
                d = d[d[:, 4] > 0]
                if len(d) == 0:
                    if len(gt_cls):
                        stats["tp"].append(np.zeros((0, len(self.iouv)), bool))
                        stats["conf"].append(np.zeros(0))
                        stats["pred_cls"].append(np.zeros(0))
                        stats["target_cls"].append(gt_cls)
                        confusion.process_batch(None, gt_xyxy, gt_cls)
                    continue
                iou = _box_iou_np(gt_xyxy, d[:, :4])
                stats["tp"].append(match_predictions(d[:, 5], gt_cls, iou, self.iouv))
                stats["conf"].append(d[:, 4])
                stats["pred_cls"].append(d[:, 5])
                stats["target_cls"].append(gt_cls)
                confusion.process_batch(d, gt_xyxy, gt_cls)
            if write:
                for i in range(b):
                    k = int(im_idx[i]) if im_idx is not None else n_img - b + i
                    if k < 0 or k >= len(im_files):  # rows that pad a batch
                        continue
                    d, wh = boxes_to_original(dets[i][dets[i][:, 4] > 0], im_files[k], (h, w))
                    if self.save_json:
                        jdict.extend(pred_to_json(d, im_files[k], class_map=self.class_map))
                    if self.save_txt:
                        save_label_txt(self.save_dir / "labels" / f"{Path(im_files[k]).stem}.txt", d, wh,
                                       self.save_conf)
        if write and self.save_json:
            out = self.save_dir / "predictions.json"
            out.parent.mkdir(parents=True, exist_ok=True)
            save_predictions_json(jdict, out)
            LOGGER.info(f"saved {len(jdict)} COCO-format predictions to {out}")

        metrics = DetMetrics(names=self.names)
        if stats["tp"]:
            target_cls = np.concatenate(stats["target_cls"])
            if len(target_cls):
                metrics.process(np.concatenate(stats["tp"]), np.concatenate(stats["conf"]),
                                np.concatenate(stats["pred_cls"]), target_cls)
        # the time spent waiting for each batch's rows, not the device's time: the
        # next batch's forward is already enqueued while this one is matched
        metrics.speed["inference"] = t_infer / max(n_img, 1) * 1000
        metrics.confusion_matrix = confusion
        return metrics
