"""Detection loss: EMA-Slide BCE + CIoU/NWD box loss + DFL
(counterpart of ``bsyolo_tpu/losses/detect.py``).

The EMA-Slide loss's running state (the update count and the decayed IoU
mean) is an explicit ``LossState`` of float32 and int32 tensors on the
card, passed in and returned, so a step reads nothing back. Ground truths
arrive padded to ``M`` rows with a validity mask.

Head maps are the port's NCHW levels (B, 4 * reg_max + nc, H, W); anchors are
flattened level by level, row-major within a level, as in the JAX package's
NHWC maps, so anchor ``a`` is the same cell in both. Maps of the bf16 graph
are cast to float32 on entry, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import torch

from bsyolo_tpu_torch.losses.tal import task_aligned_assign
from bsyolo_tpu_torch.nn.modules import dfl_decode
from bsyolo_tpu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from bsyolo_tpu_torch.ops.boxes import bbox_iou, wasserstein_loss, xywh2xyxy


class DetectionLossConfig(NamedTuple):
    nc: int
    strides: Tuple[int, ...]
    reg_max: int = 16
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    nwd_loss: bool = True  # the fork's default cfg: nwdloss True
    iou_ratio: float = 0.6  # the fork's default cfg: CIoU's share of the box loss
    tal_topk: int = 10
    ema_decay: float = 0.4  # EMASlideLoss decay
    ema_tau: float = 2000.0
    assigner_bf16: bool = False  # the TAL ranking math in bfloat16 (its targets stay float32)


@dataclass
class LossState:
    """EMA-Slide state: ``updates`` () int32 and ``iou_mean`` () float32 tensors."""

    updates: torch.Tensor
    iou_mean: torch.Tensor


def init_loss_state(device=None) -> LossState:
    return LossState(updates=torch.zeros((), dtype=torch.int32, device=device),
                     iou_mean=torch.ones((), dtype=torch.float32, device=device))


def _ema_slide_weight(true: torch.Tensor, auto_iou: torch.Tensor) -> torch.Tensor:
    """The slide's modulating weight: 1 below auto_iou - 0.1, e^(1 - auto_iou) up to
    auto_iou, e^(1 - true) from there."""
    auto_iou = auto_iou.clamp(min=0.2)
    b1 = (true <= auto_iou - 0.1).to(true.dtype)
    b2 = ((true > auto_iou - 0.1) & (true < auto_iou)).to(true.dtype)
    b3 = (true >= auto_iou).to(true.dtype)
    return b1 + torch.exp(1.0 - auto_iou) * b2 + torch.exp(-(true - 1.0)) * b3


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits, in the JAX package's stable form."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss, mean over the 4 sides; (..., 1).

    pred_dist: (..., 4, reg_max) logits; target: (..., 4) continuous distances.
    The two-bin target is a weighted soft one-hot contracted against the
    log-softmax, as in the JAX package.
    """
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.floor().long()
    tr = (tl + 1).clamp(0, reg_max - 1)
    wl = (tl + 1).to(target.dtype) - target
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist.float(), -1)
    iota = torch.arange(reg_max, device=pred_dist.device)
    soft = (tl[..., None] == iota).to(logp.dtype) * wl[..., None] + (tr[..., None] == iota).to(logp.dtype) * wr[..., None]
    return -(logp * soft).sum(-1).mean(-1, keepdim=True)


class DetectTerms(NamedTuple):
    """The detection terms of a head's loss and what the task losses build on."""

    loss_iou: torch.Tensor  # () CIoU (blended with NWD), 0 without foreground
    loss_cls: torch.Tensor  # ()
    loss_dfl: torch.Tensor  # (), 0 without foreground
    state: LossState  # the EMA-Slide state after this call
    extra: torch.Tensor  # (B, A, no - 4 * reg_max - nc) float32: the channels past the class logits
    anchor_points: torch.Tensor  # (A, 2) feature units
    stride_tensor: torch.Tensor  # (A, 1)
    assign: object  # the TAL AssignResult (pixel boxes)
    weight: torch.Tensor  # (B, A) target score sums on the foreground, 0 elsewhere
    imgsz: Tuple[int, int]  # (h, w) of the network input


def detect_terms(
    feats: Sequence[torch.Tensor],  # per-level raw maps (B, 4 * reg_max + nc [+ extra], H, W)
    gt_cls: torch.Tensor,  # (B, M) int
    gt_bboxes: torch.Tensor,  # (B, M, 4) xywh normalized to [0, 1]
    gt_mask: torch.Tensor,  # (B, M) validity
    state: LossState,
    cfg: DetectionLossConfig,
) -> DetectTerms:
    """TAL assignment, EMA-Slide BCE, CIoU/NWD and DFL over the head's first ``4 * reg_max + nc``
    channels; the Segment and Pose losses add their terms on the rest."""
    reg_max, nc = cfg.reg_max, cfg.nc
    feat_shapes = [tuple(f.shape[2:]) for f in feats]
    imgsz_h = feat_shapes[0][0] * cfg.strides[0]
    imgsz_w = feat_shapes[0][1] * cfg.strides[0]
    dev = feats[0].device

    flat = torch.cat([f.flatten(2) for f in feats], 2).transpose(1, 2)  # (B, A, no)
    pred_distri = flat[..., : reg_max * 4].float()
    pred_scores = flat[..., reg_max * 4 : reg_max * 4 + nc].float()
    anchor_points, stride_tensor = make_anchors(feat_shapes, cfg.strides, 0.5, device=dev)

    # targets: normalized xywh -> pixel xyxy
    scale = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h], dtype=torch.float32, device=dev)
    gt_xyxy = xywh2xyxy(gt_bboxes.float() * scale)
    mask_gt = gt_mask.bool() & (gt_xyxy.sum(-1) > 0)

    # predicted boxes in feature units
    pred_bboxes = dist2bbox(dfl_decode(pred_distri, reg_max), anchor_points[None], xywh=False)

    assign = task_aligned_assign(
        pred_scores.detach().sigmoid(),
        pred_bboxes.detach() * stride_tensor[None],
        anchor_points * stride_tensor,
        gt_cls,
        gt_xyxy,
        mask_gt,
        topk=cfg.tal_topk,
        num_classes=nc,
        alpha=0.5,
        beta=6.0,
        bf16=cfg.assigner_bf16,
    )
    target_bboxes, target_scores, fg_mask = assign.target_bboxes, assign.target_scores, assign.fg_mask
    target_scores_sum = target_scores.sum().clamp(min=1.0)

    # cls: BCE weighted by the EMA slide; auto_iou is the call site's 0.2, decayed into iou_mean
    new_updates = state.updates + 1
    d = cfg.ema_decay * (1.0 - torch.exp(-new_updates.float() / cfg.ema_tau))
    new_iou_mean = d * state.iou_mean + (1.0 - d) * 0.2
    weight = _ema_slide_weight(target_scores, new_iou_mean)
    loss_cls = (_bce_with_logits(pred_scores, target_scores) * weight).sum() / target_scores_sum

    # box: CIoU, blended with NWD, over the foreground anchors
    target_bboxes_feat = target_bboxes / stride_tensor[None]
    w = target_scores.sum(-1) * fg_mask  # (B, A)
    iou = bbox_iou(pred_bboxes, target_bboxes_feat, xywh=False, CIoU=True)[..., 0]
    loss_iou = ((1.0 - iou) * w).sum() / target_scores_sum
    if cfg.nwd_loss:
        nwd = wasserstein_loss(pred_bboxes, target_bboxes_feat)[..., 0]
        loss_nwd = ((1.0 - nwd) * w).sum() / target_scores_sum
        loss_iou = cfg.iou_ratio * loss_iou + (1.0 - cfg.iou_ratio) * loss_nwd

    target_ltrb = bbox2dist(anchor_points[None], target_bboxes_feat, reg_max - 1)
    dfl = _dfl_loss(pred_distri.unflatten(-1, (4, reg_max)), target_ltrb, reg_max)[..., 0]
    loss_dfl = (dfl * w).sum() / target_scores_sum

    any_fg = fg_mask.any()
    zero = loss_iou.new_zeros(())
    loss_iou = torch.where(any_fg, loss_iou, zero)
    loss_dfl = torch.where(any_fg, loss_dfl, zero)
    return DetectTerms(loss_iou, loss_cls, loss_dfl, LossState(updates=new_updates, iou_mean=new_iou_mean),
                       flat[..., reg_max * 4 + nc :].float(), anchor_points, stride_tensor, assign, w,
                       (imgsz_h, imgsz_w))


def detection_loss(
    feats: Sequence[torch.Tensor],  # per-level raw maps (B, 4 * reg_max + nc, H, W)
    gt_cls: torch.Tensor,  # (B, M) int
    gt_bboxes: torch.Tensor,  # (B, M, 4) xywh normalized to [0, 1]
    gt_mask: torch.Tensor,  # (B, M) validity
    state: LossState,
    cfg: DetectionLossConfig,
) -> Tuple[torch.Tensor, torch.Tensor, LossState]:
    """(total loss, loss items [box, cls, dfl] (3,), new state); the total is
    ``sum(items) * B``, as the reference scales it."""
    t = detect_terms(feats, gt_cls, gt_bboxes, gt_mask, state, cfg)
    items = torch.stack([t.loss_iou * cfg.box, t.loss_cls * cfg.cls, t.loss_dfl * cfg.dfl])
    return items.sum() * feats[0].shape[0], items, t.state
