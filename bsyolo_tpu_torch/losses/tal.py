"""Task-aligned assigner (counterpart of ``bsyolo_tpu/losses/tal.py``).

A dense masked computation over (batch, max_gt, anchors): the padded ground
truth rows take part with a validity mask, so every shape is static and no
step of the assignment reads anything back from the card.

The top-k per ground truth is a threshold, as in the JAX package, not
``torch.topk``: ``_kth_largest`` counts each distinct value once, and an
anchor is a candidate where its metric is ``>=`` that k-th value and ``> 0``.
Tied anchors are all kept, and a row with fewer than k distinct values keeps
every positive anchor. ``torch.topk(...).values[..., k - 1]`` counts
duplicates and would keep other anchors on ties.

``bf16=True`` runs the dense (b, M, A) ranking math in bfloat16, as the JAX
option does: the centre-inside test stays float32, target boxes and labels
are gathered from the float32 inputs, and ``target_scores`` come back in the
scores' dtype. Selection can differ from float32 only where two anchors'
metrics agree to bfloat16 precision; the threshold keeps every anchor tied at
the k-th bfloat16 value, as the JAX threshold does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from bsyolo_tpu_torch.ops.boxes import bbox_iou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (b, A) int64
    target_bboxes: torch.Tensor  # (b, A, 4) xyxy, in the units of the inputs
    target_scores: torch.Tensor  # (b, A, nc)
    fg_mask: torch.Tensor  # (b, A) bool
    target_gt_idx: torch.Tensor  # (b, A) int64


def _select_candidates_in_gts(anc_points: torch.Tensor, gt_bboxes: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """(A, 2) anchor points strictly inside (b, M, 4) xyxy boxes -> (b, M, A) bool."""
    lt = anc_points[None, None] - gt_bboxes[:, :, None, :2]
    rb = gt_bboxes[:, :, None, 2:] - anc_points[None, None]
    return torch.minimum(lt.amin(-1), rb.amin(-1)) > eps


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest distinct value along the last axis, keepdim: k - 1 masked max
    passes. With fewer than k distinct values the result is -inf."""
    t = x.amax(-1, keepdim=True)
    for _ in range(k - 1):
        t = torch.where(x < t, x, float("-inf")).amax(-1, keepdim=True)
    return t


@torch.no_grad()
def task_aligned_assign(
    pd_scores: torch.Tensor,  # (b, A, nc) sigmoided
    pd_bboxes: torch.Tensor,  # (b, A, 4) xyxy
    anc_points: torch.Tensor,  # (A, 2)
    gt_labels: torch.Tensor,  # (b, M) int
    gt_bboxes: torch.Tensor,  # (b, M, 4) xyxy
    mask_gt: torch.Tensor,  # (b, M) bool or float
    topk: int = 10,
    num_classes: int = 80,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
    bf16: bool = False,
) -> AssignResult:
    """Static-shape task-aligned assignment; carries no gradient."""
    out_dtype = pd_scores.dtype
    gt_bboxes_full = gt_bboxes
    b, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    mask_gt = mask_gt.bool()

    mask_valid = _select_candidates_in_gts(anc_points, gt_bboxes) & mask_gt[:, :, None]  # (b, M, A)
    if bf16:  # only the ranking math: the centre test above and the gathered targets stay float32
        pd_scores, pd_bboxes, gt_bboxes = (t.to(torch.bfloat16) for t in (pd_scores, pd_bboxes, gt_bboxes))

    # alignment metric: score[gt label] ** alpha * CIoU ** beta
    labels = gt_labels.long().clamp(0, nc - 1)
    bbox_scores = pd_scores.gather(2, labels[:, None, :].expand(b, A, M)).transpose(1, 2)  # (b, M, A)
    bbox_scores = torch.where(mask_valid, bbox_scores, 0.0)
    overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False, CIoU=True)[..., 0]
    overlaps = torch.where(mask_valid, overlaps.clamp(min=0.0), 0.0)
    align_metric = bbox_scores.pow(alpha) * overlaps.pow(beta)

    kth = _kth_largest(align_metric, min(topk, A))  # (b, M, 1)
    mask_pos = (align_metric >= kth) & (align_metric > 0.0) & mask_valid  # (b, M, A)

    # an anchor claimed by several ground truths keeps the one of highest CIoU (the first on ties)
    multi = mask_pos.sum(1, keepdim=True) > 1  # (b, 1, A)
    max_overlaps_idx = overlaps.argmax(1)  # (b, A)
    is_max = torch.arange(M, device=overlaps.device)[None, :, None] == max_overlaps_idx[:, None, :]
    mask_pos = torch.where(multi, is_max, mask_pos)
    fg_mask = mask_pos.any(1)  # (b, A)
    target_gt_idx = mask_pos.to(torch.uint8).argmax(1)  # (b, A); argmax does not take bool

    target_labels = labels.gather(1, target_gt_idx)
    target_bboxes = gt_bboxes_full.gather(1, target_gt_idx[..., None].expand(b, A, 4))
    target_scores = F.one_hot(target_labels, nc).to(out_dtype) * fg_mask[..., None]

    # normalize by each ground truth's largest alignment
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)  # (b, M, 1)
    pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)  # (b, M, 1)
    norm = (align_metric * pos_overlaps / (pos_align + eps)).amax(-2).to(out_dtype)  # (b, A)
    return AssignResult(target_labels, target_bboxes, target_scores * norm[..., None], fg_mask, target_gt_idx)
