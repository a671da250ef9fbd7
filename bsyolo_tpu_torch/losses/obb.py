"""Oriented-box detection loss (counterpart of ``bsyolo_tpu/losses/obb.py``).

Rotated task-aligned assignment over (batch, max_gt, anchors) with a
validity mask, as ``losses/tal.py`` does for axis-aligned boxes: an anchor is
a candidate where it lies inside the rotated ground truth (corner
dot-products), the alignment metric is score^0.5 * probIoU^6, and each
ground truth takes its ``topk`` best anchors (``jax.lax.top_k``'s order, ties
to the lower index). The loss is the EMA-Slide BCE of the detection loss,
1 - probIoU on the foreground anchors and DFL on the axis-aligned distances of
the rotated target. Items: [box, cls, dfl].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from bsyolo_tpu_torch.losses.detect import (DetectionLossConfig, LossState, _bce_with_logits, _dfl_loss,
                                            _ema_slide_weight)
from bsyolo_tpu_torch.nn.modules import dfl_decode
from bsyolo_tpu_torch.ops.anchors import bbox2dist, dist2rbox, make_anchors
from bsyolo_tpu_torch.ops.boxes import xywh2xyxy
from bsyolo_tpu_torch.ops.nms import _top_k
from bsyolo_tpu_torch.ops.obb import probiou, xywhr2xyxyxyxy


class RotatedAssignResult(NamedTuple):
    target_rboxes: torch.Tensor  # (b, A, 5) xywhr, in the units of the inputs
    target_scores: torch.Tensor  # (b, A, nc)
    fg_mask: torch.Tensor  # (b, A) bool
    target_gt_idx: torch.Tensor  # (b, A) int64


def _candidates_in_rotated_gts(anc_points: torch.Tensor, gt_rboxes: torch.Tensor) -> torch.Tensor:
    """(A, 2) anchor points inside (b, M, 5) xywhr boxes, edges included -> (b, M, A) bool."""
    corners = xywhr2xyxyxyxy(gt_rboxes)  # (b, M, 4, 2)
    a, b, d = (corners[..., j, None, :] for j in (0, 1, 3))  # (b, M, 1, 2)
    ab, ad = b - a, d - a
    ap = anc_points[None, None] - a  # (b, M, A, 2)
    norm_ab, norm_ad = (ab * ab).sum(-1), (ad * ad).sum(-1)
    ap_ab, ap_ad = (ap * ab).sum(-1), (ap * ad).sum(-1)
    return (ap_ab >= 0) & (ap_ab <= norm_ab) & (ap_ad >= 0) & (ap_ad <= norm_ad)


@torch.no_grad()
def rotated_task_aligned_assign(
    pd_scores: torch.Tensor,  # (b, A, nc) sigmoided
    pd_rboxes: torch.Tensor,  # (b, A, 5) xywhr
    anc_points: torch.Tensor,  # (A, 2)
    gt_labels: torch.Tensor,  # (b, M) int
    gt_rboxes: torch.Tensor,  # (b, M, 5) xywhr
    mask_gt: torch.Tensor,  # (b, M) bool or float
    topk: int = 10,
    num_classes: int = 80,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
) -> RotatedAssignResult:
    """Static-shape rotated task-aligned assignment; carries no gradient."""
    b, A, nc = pd_scores.shape
    M = gt_rboxes.shape[1]
    mask_gt = mask_gt.bool()
    mask_valid = _candidates_in_rotated_gts(anc_points, gt_rboxes) & mask_gt[:, :, None]

    labels = gt_labels.long().clamp(0, nc - 1)
    bbox_scores = pd_scores.gather(2, labels[:, None, :].expand(b, A, M)).transpose(1, 2)  # (b, M, A)
    bbox_scores = torch.where(mask_valid, bbox_scores, 0.0)
    overlaps = probiou(gt_rboxes[:, :, None, :], pd_rboxes[:, None, :, :])[..., 0]
    overlaps = torch.where(mask_valid, overlaps.clamp(min=0.0), 0.0)
    align = bbox_scores.pow(alpha) * overlaps.pow(beta)

    _, topk_idx = _top_k(align, min(topk, A))  # (b, M, k)
    in_topk = torch.zeros((b, M, A), dtype=torch.bool, device=align.device).scatter_(2, topk_idx, True)
    mask_pos = in_topk & mask_gt[:, :, None] & mask_valid

    # an anchor claimed by several ground truths keeps the one of highest probIoU (the first on ties)
    multi = mask_pos.sum(1, keepdim=True) > 1
    is_max = torch.arange(M, device=align.device)[None, :, None] == overlaps.argmax(1)[:, None, :]
    mask_pos = torch.where(multi, is_max, mask_pos)
    fg_mask = mask_pos.any(1)
    target_gt_idx = mask_pos.to(torch.uint8).argmax(1)

    target_labels = labels.gather(1, target_gt_idx)
    target_rboxes = gt_rboxes.gather(1, target_gt_idx[..., None].expand(b, A, 5))
    target_scores = F.one_hot(target_labels, nc).to(pd_scores.dtype) * fg_mask[..., None]

    align = align * mask_pos
    pos_align = align.amax(-1, keepdim=True)
    pos_over = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align * pos_over / (pos_align + eps)).amax(-2)
    return RotatedAssignResult(target_rboxes, target_scores * norm[..., None], fg_mask, target_gt_idx)


def obb_loss(
    feats: Sequence[torch.Tensor],  # per-level maps (B, 4 * reg_max + nc + ne, H, W)
    gt_cls: torch.Tensor,  # (B, M)
    gt_rboxes: torch.Tensor,  # (B, M, 5) xywhr: xy and wh normalized, r in radians
    gt_mask: torch.Tensor,  # (B, M)
    state: LossState,
    cfg: DetectionLossConfig,
) -> Tuple[torch.Tensor, torch.Tensor, LossState]:
    """(total, items [box, cls, dfl], new state); the total is ``sum(items) * B``. Ground truths
    under 2 px wide or high are left out, as the reference filters them."""
    reg_max, nc = cfg.reg_max, cfg.nc
    b = feats[0].shape[0]
    feat_shapes = [tuple(f.shape[2:]) for f in feats]
    imgsz_h, imgsz_w = feat_shapes[0][0] * cfg.strides[0], feat_shapes[0][1] * cfg.strides[0]
    dev = feats[0].device

    flat = torch.cat([f.flatten(2) for f in feats], 2).transpose(1, 2)  # (B, A, no)
    pred_distri = flat[..., : reg_max * 4].float()
    pred_scores = flat[..., reg_max * 4 : reg_max * 4 + nc].float()
    pred_angle = (torch.sigmoid(flat[..., reg_max * 4 + nc :].float()) - 0.25) * math.pi  # (B, A, ne)
    anchor_points, stride_tensor = make_anchors(feat_shapes, cfg.strides, 0.5, device=dev)

    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32, device=dev)
    gt_px = torch.cat([gt_rboxes[..., :4].float() * scale, gt_rboxes[..., 4:5].float()], -1)
    mask_gt = gt_mask.bool() & (gt_px[..., 2] >= 2.0) & (gt_px[..., 3] >= 2.0)

    pred_rboxes = dist2rbox(dfl_decode(pred_distri, reg_max), pred_angle, anchor_points[None])  # feature units
    pred_rboxes_full = torch.cat([pred_rboxes, pred_angle], -1)
    pd_px = torch.cat([pred_rboxes * stride_tensor[None], pred_angle], -1)
    assign = rotated_task_aligned_assign(pred_scores.detach().sigmoid(), pd_px.detach(), anchor_points * stride_tensor,
                                         gt_cls, gt_px, mask_gt, topk=cfg.tal_topk, num_classes=nc)
    target_scores, fg_mask = assign.target_scores, assign.fg_mask
    target_scores_sum = target_scores.sum().clamp(min=1.0)

    new_updates = state.updates + 1
    d = cfg.ema_decay * (1.0 - torch.exp(-new_updates.float() / cfg.ema_tau))
    new_iou_mean = d * state.iou_mean + (1.0 - d) * 0.2
    loss_cls = (_bce_with_logits(pred_scores, target_scores)
                * _ema_slide_weight(target_scores, new_iou_mean)).sum() / target_scores_sum

    tb_feat = torch.cat([assign.target_rboxes[..., :4] / stride_tensor[None], assign.target_rboxes[..., 4:5]], -1)
    w = target_scores.sum(-1) * fg_mask
    iou = probiou(pred_rboxes_full, tb_feat)[..., 0]
    loss_iou = ((1.0 - iou) * w).sum() / target_scores_sum
    target_ltrb = bbox2dist(anchor_points[None], xywh2xyxy(tb_feat[..., :4]), reg_max - 1)
    dfl = _dfl_loss(pred_distri.unflatten(-1, (4, reg_max)), target_ltrb, reg_max)[..., 0]
    loss_dfl = (dfl * w).sum() / target_scores_sum

    any_fg = fg_mask.any()
    loss_iou = torch.where(any_fg, loss_iou, pred_angle.sum() * 0.0)
    loss_dfl = torch.where(any_fg, loss_dfl, loss_dfl.new_zeros(()))
    items = torch.stack([loss_iou * cfg.box, loss_cls * cfg.cls, loss_dfl * cfg.dfl])
    return items.sum() * b, items, LossState(updates=new_updates, iou_mean=new_iou_mean)
