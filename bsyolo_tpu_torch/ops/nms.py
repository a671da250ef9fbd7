"""Non-max suppression (counterpart of ``bsyolo_tpu/ops/nms.py``).

Fixed-shape outputs like the JAX package: (B, max_det, 6) rows of x1, y1, x2,
y2, conf, cls, padded with conf 0 and cls -1. ``nms_from_logits`` chooses
candidates on raw logits (sigmoid is monotonic) and sigmoids only the chosen
ones; ``non_max_suppression`` takes decoded xywh boxes and sigmoid scores.
Greedy suppression is the fixed-point iteration

    K_{t+1}[j] = valid[j] and not exists i < j with K_t[i] and IoU(i, j) > thresh

over the score-sorted candidate IoU matrix, run for the whole batch at once.

Orders follow ``jax.lax.top_k``: where scores tie, the lower index comes
first, so every ranking here is a stable descending sort.
"""

from __future__ import annotations

import torch

from bsyolo_tpu_torch.ops.boxes import box_iou_pairwise, xywh2xyxy


def _top_k(x: torch.Tensor, k: int):
    """Largest ``k`` along the last dim, ties broken by lower index (as lax.top_k)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _greedy_keep(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float):
    """Exact greedy-NMS keep mask (B, k) from (B, k, k) IoUs of score-sorted candidates.

    A Python loop to the fixed point, at most k iterations (a chain of k
    suppressions); its stop test reads one flag back from the device per iteration.
    Under ``torch.export`` the same fixed point is a ``while_loop`` (``_greedy_keep_traced``).
    """
    k = iou.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)  # i < j
    sup = (iou > iou_thres) & upper & valid[..., :, None]
    if torch.compiler.is_exporting():
        return _greedy_keep_traced(sup, valid)
    keep = valid
    for _ in range(k):
        new_keep = valid & ~(sup & keep[..., :, None]).any(-2)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def _greedy_keep_traced(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``_greedy_keep``'s fixed point as a ``while_loop`` that ``torch.export`` records (its stop test is a
    tensor, not a value read back): at most k iterations, the same keep mask. The ONNX writer lowers it to
    a ``Loop`` (``onnx/lower.py``), as the JAX exporter lowers ``lax.while_loop``."""
    from torch._higher_order_ops import while_loop

    def cond(i, keep, changed):
        return (i < sup.shape[-1]) & changed

    def body(i, keep, changed):
        new_keep = valid & ~(sup & keep[..., :, None]).any(-2)
        return i + 1, new_keep, (new_keep != keep).any()

    start = (torch.zeros((), dtype=torch.int64, device=sup.device), valid.clone(),
             torch.ones((), dtype=torch.bool, device=sup.device))
    return while_loop(cond, body, start)[1]


def _nms(
    boxes: torch.Tensor,  # (B, A, 4) xyxy pixels
    cls_values: torch.Tensor,  # (B, A, nc) class logits or scores
    best: torch.Tensor,  # (B, A) max of cls_values per anchor
    to_score,  # cls_values -> scores in (0, 1): sigmoid for logits, None for scores
    conf_thres: float,
    iou_thres: float,
    max_det: int,
    pre_k: int,
    multi_label: bool,
    agnostic: bool,
    max_wh: float,
    return_idx: bool,
):
    """Batched NMS shared by both entries: candidates ranked on ``cls_values``
    (two-stage multi-label top-k), greedy suppression, top ``max_det`` kept."""
    B, A, nc = cls_values.shape
    boxes = boxes.float()
    ka = min(pre_k, A)
    _, top_anchors = _top_k(best, ka)  # (B, ka)
    sub = torch.gather(cls_values, 1, top_anchors[..., None].expand(B, ka, nc)).float()  # (B, ka, nc)
    if multi_label and nc > 1:
        k = min(pre_k, ka * nc)
        cand_values, flat_idx = _top_k(sub.reshape(B, ka * nc), k)
        rel = flat_idx // nc
        cls_idx = (flat_idx % nc).float()
    else:
        k = ka
        cand_values = sub.amax(-1)
        rel = torch.arange(ka, device=sub.device).expand(B, ka)
        cls_idx = sub.argmax(-1).float()
    cand_scores = cand_values if to_score is None else to_score(cand_values)
    anchor_idx = torch.gather(top_anchors, 1, rel)
    cand_boxes = torch.gather(boxes, 1, anchor_idx[..., None].expand(B, k, 4))

    valid = cand_scores > conf_thres
    shifted = cand_boxes if agnostic else cand_boxes + cls_idx[..., None] * max_wh
    keep = _greedy_keep(box_iou_pairwise(shifted, shifted), valid, iou_thres)

    m = min(max_det, k)
    out_scores, out_idx = _top_k(torch.where(keep, cand_scores, -1.0), m)
    sel_boxes = torch.gather(cand_boxes, 1, out_idx[..., None].expand(B, m, 4))
    sel_cls = torch.gather(cls_idx, 1, out_idx)
    sel_anchor = torch.gather(anchor_idx, 1, out_idx)
    ok = out_scores > 0
    out = torch.cat(
        [
            torch.where(ok[..., None], sel_boxes, 0.0),
            torch.where(ok, out_scores, 0.0)[..., None],
            torch.where(ok, sel_cls, -1.0)[..., None],
        ],
        -1,
    )
    sel_anchor = torch.where(ok, sel_anchor, -1)
    if max_det > k:  # pad if the caller asked for more slots than candidates
        pad = torch.zeros((B, max_det - k, 6), dtype=out.dtype, device=out.device)
        pad[..., 5] = -1.0
        out = torch.cat([out, pad], 1)
        sel_anchor = torch.cat([sel_anchor, sel_anchor.new_full((B, max_det - k), -1)], 1)
    return (out, sel_anchor) if return_idx else out


def nms_from_logits(
    boxes: torch.Tensor,  # (B, A, 4) xyxy pixels
    cls_logits: torch.Tensor,  # (B, A, nc) raw class logits
    best_logit: torch.Tensor,  # (B, A) max class logit per anchor
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    max_det: int = 300,
    pre_k: int = 1024,
    multi_label: bool = True,
    agnostic: bool = False,
    max_wh: float = 7680.0,
    return_idx: bool = False,
):
    """Batched logit-domain NMS -> (B, max_det, 6) [+ (B, max_det) source anchors, -1 for padding]."""
    return _nms(boxes, cls_logits, best_logit, torch.sigmoid, conf_thres, iou_thres, max_det, pre_k, multi_label,
                agnostic, max_wh, return_idx)


def non_max_suppression(
    prediction: torch.Tensor,  # (B, A, 4 + nc) xywh pixels + sigmoid class scores
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    max_det: int = 300,
    pre_k: int = 1024,
    nc: int = 0,
    multi_label: bool = True,
    agnostic: bool = False,
    max_wh: float = 7680.0,
    return_idx: bool = False,
):
    """Batched NMS on decoded predictions (``decode_detections``' layout) ->
    (B, max_det, 6) [+ (B, max_det) source anchors, -1 for padding].

    Ranks the sigmoid scores themselves, so saturated scores tie and the
    lower anchor comes first. ``nc`` is inferred from the width when 0.
    """
    if nc <= 0:
        nc = prediction.shape[-1] - 4
    prediction = prediction.float()
    scores = prediction[..., 4 : 4 + nc]
    return _nms(xywh2xyxy(prediction[..., :4]), scores, scores.amax(-1), None, conf_thres, iou_thres, max_det, pre_k,
                multi_label, agnostic, max_wh, return_idx)
