"""Logit-domain non-max suppression (counterpart of ``bsyolo_tpu/ops/nms.py``).

Fixed-shape outputs like the JAX package: (B, max_det, 6) rows of x1, y1, x2,
y2, conf, cls, padded with conf 0 and cls -1. Candidates are chosen on raw
logits (sigmoid is monotonic) and only the chosen ones are sigmoided. Greedy
suppression is the fixed-point iteration

    K_{t+1}[j] = valid[j] and not exists i < j with K_t[i] and IoU(i, j) > thresh

over the score-sorted candidate IoU matrix, run for the whole batch at once.

Orders follow ``jax.lax.top_k``: where scores tie, the lower index comes
first, so every ranking here is a stable descending sort.
"""

from __future__ import annotations

import torch

from bsyolo_tpu_torch.ops.boxes import box_iou_pairwise


def _top_k(x: torch.Tensor, k: int):
    """Largest ``k`` along the last dim, ties broken by lower index (as lax.top_k)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _greedy_keep(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float):
    """Exact greedy-NMS keep mask (B, k) from (B, k, k) IoUs of score-sorted candidates.

    A Python loop to the fixed point, at most k iterations (a chain of k
    suppressions); its stop test reads one flag back from the device per iteration.
    """
    k = iou.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)  # i < j
    sup = (iou > iou_thres) & upper & valid[..., :, None]
    keep = valid
    for _ in range(k):
        new_keep = valid & ~(sup & keep[..., :, None]).any(-2)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


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
    B, A, nc = cls_logits.shape
    boxes = boxes.float()
    ka = min(pre_k, A)
    _, top_anchors = _top_k(best_logit, ka)  # (B, ka)
    sub = torch.gather(cls_logits, 1, top_anchors[..., None].expand(B, ka, nc)).float()  # (B, ka, nc)
    if multi_label and nc > 1:
        k = min(pre_k, ka * nc)
        cand_logits, flat_idx = _top_k(sub.reshape(B, ka * nc), k)
        rel = flat_idx // nc
        cls_idx = (flat_idx % nc).float()
    else:
        k = ka
        cand_logits = sub.amax(-1)
        rel = torch.arange(ka, device=sub.device).expand(B, ka)
        cls_idx = sub.argmax(-1).float()
    cand_scores = torch.sigmoid(cand_logits)
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
