"""Pose estimation loss (counterpart of ``bsyolo_tpu/losses/pose.py``).

The detection terms (``losses/detect.py detect_terms``) plus an OKS
keypoint-location loss and a keypoint-visibility BCE, dense and masked over
all anchors, as in the JAX package. Item order: [box, pose, kobj, cls, dfl].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from bsyolo_tpu_torch.losses.detect import DetectionLossConfig, LossState, _bce_with_logits, detect_terms

# COCO's per-keypoint OKS sigmas
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89,
                      0.89]) / 10.0


def oks_sigmas(kpt_shape: Tuple[int, int]) -> np.ndarray:
    """COCO's sigmas for 17 x 3 keypoints, else 1 / nkpt each."""
    nkpt, nd = kpt_shape
    return OKS_SIGMA if (nkpt == 17 and nd == 3) else np.ones(nkpt) / nkpt


def pose_loss(
    feats: Sequence[torch.Tensor],  # per-level maps (B, 4 * reg_max + nc + nk, H, W)
    gt_cls: torch.Tensor,  # (B, M)
    gt_bboxes: torch.Tensor,  # (B, M, 4) normalized xywh
    gt_mask: torch.Tensor,  # (B, M)
    gt_kpts: torch.Tensor,  # (B, M, nkpt, 2 | 3) normalized coordinates (+ visibility)
    state: LossState,
    cfg: DetectionLossConfig,
    kpt_shape: Tuple[int, int] = (17, 3),
    pose_gain: float = 12.0,
    kobj_gain: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, LossState]:
    """(total, items [box, pose, kobj, cls, dfl], new state); the total is ``sum(items) * B``."""
    nkpt, nd = kpt_shape
    b = feats[0].shape[0]
    t = detect_terms(feats, gt_cls, gt_bboxes, gt_mask, state, cfg)
    anchors, stride_t = t.anchor_points, t.stride_tensor
    a = anchors.shape[0]
    imgsz_h, imgsz_w = t.imgsz
    fg_mask = t.assign.fg_mask

    # keypoints decoded in feature units
    pk = t.extra.reshape(b, a, nkpt, nd)
    pk_xy = pk[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)
    pred_kpts = torch.cat([pk_xy, pk[..., 2:]], -1) if nd == 3 else pk_xy

    kpts_px = gt_kpts.float() * torch.tensor([imgsz_w, imgsz_h] + [1.0] * (gt_kpts.shape[-1] - 2),
                                             dtype=torch.float32, device=gt_kpts.device)
    idx = t.assign.target_gt_idx[:, :, None, None].expand(b, a, *kpts_px.shape[2:])
    sel = kpts_px.gather(1, idx)  # (B, A, nkpt, nd)
    sel = torch.cat([sel[..., :2] / stride_t[None, :, None, :], sel[..., 2:]], -1)

    kpt_vis = sel[..., 2] != 0 if nd == 3 else torch.ones(sel.shape[:-1], dtype=torch.bool, device=sel.device)
    fgk = fg_mask[..., None]  # (B, A, 1)
    sig = torch.as_tensor(oks_sigmas(kpt_shape), dtype=torch.float32, device=sel.device)
    tb = t.assign.target_bboxes / stride_t[None]
    area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])).clamp(min=1e-9)[..., None]  # (B, A, 1)
    dsq = ((pred_kpts[..., :2] - sel[..., :2]) ** 2).sum(-1)  # (B, A, nkpt)
    e = dsq / ((2 * sig[None, None, :]) ** 2 * (area + 1e-9) * 2)
    n_vis = (kpt_vis & fgk).sum(-1, keepdim=True)
    factor = nkpt / (n_vis + 1e-9)
    per_kpt = factor * (1 - torch.exp(-e)) * kpt_vis * fgk
    n_fg = fg_mask.sum().float().clamp(min=1.0)
    loss_pose = per_kpt.sum() / (n_fg * nkpt)
    any_fg = fg_mask.any()
    zero = loss_pose.new_zeros(())
    if nd == 3:
        loss_kobj = (_bce_with_logits(pred_kpts[..., 2], kpt_vis.float()) * fgk).sum() / (n_fg * nkpt)
        loss_kobj = torch.where(any_fg, loss_kobj, zero)
    else:
        loss_kobj = zero
    loss_pose = torch.where(any_fg, loss_pose, t.extra.sum() * 0.0)

    items = torch.stack([t.loss_iou * cfg.box, loss_pose * pose_gain, loss_kobj * kobj_gain, t.loss_cls * cfg.cls,
                         t.loss_dfl * cfg.dfl])
    return items.sum() * b, items, t.state
