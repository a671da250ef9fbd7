"""Instance segmentation loss (counterpart of ``bsyolo_tpu/losses/segment.py``).

The detection terms (``losses/detect.py detect_terms``) plus a BCE of the
prototype masks. As in the JAX package the mask term has a fixed size: per
image the ``max_masks`` anchors of largest assigned score are taken, in the
order of ``jax.lax.top_k`` (ties to the lower anchor index; a stable sort,
since ``torch.topk`` promises no order among ties, and random weights tie
many scores), and only the foreground ones among them count. Each takes its
ground truth's mask from the overlap-encoded map (pixel value g + 1 marks
instance g), cut to the assigned box, and its BCE is averaged over the box's
area. Item order: [box, seg, cls, dfl].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from bsyolo_tpu_torch.losses.detect import DetectionLossConfig, LossState, _bce_with_logits, detect_terms
from bsyolo_tpu_torch.ops.masks import crop_mask


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of each row of ``x`` (B, A) and their indices, ties to the lower
    index, as ``jax.lax.top_k``; ``k`` larger than A takes all A."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def segmentation_loss(
    outputs,  # {"feats": [(B, 4 * reg_max + nc + nm, H, W), ...], "proto": (B, nm, Hm, Wm)}
    gt_cls: torch.Tensor,  # (B, M)
    gt_bboxes: torch.Tensor,  # (B, M, 4) normalized xywh
    gt_mask: torch.Tensor,  # (B, M) validity
    gt_masks: torch.Tensor,  # (B, Hm, Wm) int overlap-encoded, or (B, M, Hm, Wm) without overlap
    state: LossState,
    cfg: DetectionLossConfig,
    nm: int = 32,
    max_masks: int = 100,
    overlap: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, LossState]:
    """(total, items [box, seg, cls, dfl], new state); the total is ``sum(items) * B``."""
    feats: Sequence[torch.Tensor] = outputs["feats"]
    proto = outputs["proto"].float()
    b = feats[0].shape[0]
    t = detect_terms(feats, gt_cls, gt_bboxes, gt_mask, state, cfg)
    pred_coeffs = t.extra  # (B, A, nm)
    assign, fg_mask, w = t.assign, t.assign.fg_mask, t.weight
    imgsz_h, imgsz_w = t.imgsz
    hm, wm = proto.shape[2:]

    sel_w, sel_idx = top_k_stable(w, max_masks)  # (B, K): anchors by assigned score
    k = sel_idx.shape[1]
    sel_valid = (sel_w > 0) & fg_mask.gather(1, sel_idx)
    sel_coeffs = pred_coeffs.gather(1, sel_idx[..., None].expand(b, k, pred_coeffs.shape[-1]))
    sel_gt = assign.target_gt_idx.gather(1, sel_idx)  # (B, K)
    sel_boxes = assign.target_bboxes.gather(1, sel_idx[..., None].expand(b, k, 4))  # pixels

    pred_masks = torch.einsum("bchw,bkc->bkhw", proto, sel_coeffs)  # logits (B, K, Hm, Wm)
    if overlap:
        gt_inst = gt_masks[:, None] == (sel_gt[:, :, None, None] + 1)
    else:
        gt_inst = gt_masks.gather(1, sel_gt[:, :, None, None].expand(b, k, hm, wm))
    ce = _bce_with_logits(pred_masks, gt_inst.float())
    mask_scale = torch.tensor([wm / imgsz_w, hm / imgsz_h, wm / imgsz_w, hm / imgsz_h], dtype=torch.float32,
                              device=proto.device)
    cropped = crop_mask(ce.reshape(b * k, hm, wm), (sel_boxes * mask_scale).reshape(b * k, 4)).reshape(b, k, hm, wm)
    area = ((sel_boxes[..., 2] - sel_boxes[..., 0]) * (sel_boxes[..., 3] - sel_boxes[..., 1])).clamp(min=1.0) \
        / (imgsz_w * imgsz_h) * (hm * wm)
    per_anchor = cropped.mean((2, 3)) * (hm * wm) / area.clamp(min=1.0)
    n_fg = fg_mask.sum().float().clamp(min=1.0)
    loss_seg = (per_anchor * sel_valid).sum() / n_fg
    loss_seg = torch.where(fg_mask.any(), loss_seg, pred_coeffs.sum() * 0.0)

    items = torch.stack([t.loss_iou * cfg.box, loss_seg * cfg.box, t.loss_cls * cfg.cls, t.loss_dfl * cfg.dfl])
    return items.sum() * b, items, t.state
