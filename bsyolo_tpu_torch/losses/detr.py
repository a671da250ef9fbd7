"""RT-DETR's training loss (counterpart of ``bsyolo_tpu/losses/detr.py``).

On the padded labels of the repo's batches (cls (B, M), bboxes (B, M, 4) normalized xywh, mask (B, M)):
every decoder layer's queries and the encoder's selected queries are matched one to one to the labels
by the Hungarian algorithm on the host (``scipy.optimize.linear_sum_assignment`` over each image's valid
columns, one round trip per prediction set), then scored by a focal class loss with IoU-weighted targets
(mean over classes, sum over queries, divided by num_gt / nq), an L1 box loss and a GIoU loss (each
summed over the matched pairs / num_gt), with the gains 1, 5 and 2. The denoising queries need no
matcher: the positives of group g sit at dn slot 2 * g * M + j for label j, averaged over the groups.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bsyolo_tpu_torch.ops.boxes import bbox_iou

CLS_GAIN, BBOX_GAIN, GIOU_GAIN = 1.0, 5.0, 2.0
MATCH_CLS, MATCH_BBOX, MATCH_GIOU = 2.0, 5.0, 2.0
FL_ALPHA, FL_GAMMA = 0.25, 2.0


def host_assign(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(B, nq, M) cost and (B, M) validity -> (B, M) the query matched to each label, -1 where invalid."""
    from scipy.optimize import linear_sum_assignment

    B, _, M = cost.shape
    out = np.full((B, M), -1, np.int64)
    for b in range(B):
        cols = np.flatnonzero(valid[b])
        if len(cols) == 0:
            continue
        c = np.nan_to_num(cost[b][:, cols], nan=0.0, posinf=0.0, neginf=0.0)
        rows, cids = linear_sum_assignment(c)
        out[b, cols[cids]] = rows
    return out


def match_cost(pred_bboxes: torch.Tensor, pred_scores: torch.Tensor, gt_cls: torch.Tensor,
               gt_bboxes: torch.Tensor) -> torch.Tensor:
    """(B, nq, M) matching cost, in float32 and without gradient: the focal class cost at each label's
    class (weight 2), the L1 box distance (5) and 1 - GIoU (2)."""
    with torch.no_grad():
        nc = pred_scores.shape[-1]
        ps = torch.sigmoid(pred_scores.float())
        pb = pred_bboxes.float()
        gc = gt_cls.long().clamp(0, nc - 1)
        p = torch.gather(ps, 2, gc[:, None, :].expand(-1, ps.shape[1], -1))  # (B, nq, M)
        neg = (1 - FL_ALPHA) * p**FL_GAMMA * -torch.log(1 - p + 1e-8)
        pos = FL_ALPHA * (1 - p) ** FL_GAMMA * -torch.log(p + 1e-8)
        gb = gt_bboxes.float()
        cost_l1 = (pb[:, :, None] - gb[:, None, :]).abs().sum(-1)
        giou = bbox_iou(pb[:, :, None], gb[:, None, :], xywh=True, GIoU=True).squeeze(-1)
        cost = MATCH_CLS * (pos - neg) + MATCH_BBOX * cost_l1 + MATCH_GIOU * (1.0 - giou)
        return torch.nan_to_num(cost, nan=0.0, posinf=0.0, neginf=0.0)


def hungarian_match(pred_bboxes: torch.Tensor, pred_scores: torch.Tensor, gt_cls: torch.Tensor,
                    gt_bboxes: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """(B, M) the query matched to each label (-1 for padding), on the predictions' device; the assignment
    runs on the host."""
    cost = match_cost(pred_bboxes, pred_scores, gt_cls, gt_bboxes)
    assign = host_assign(cost.cpu().numpy(), (gt_mask > 0).cpu().numpy())
    return torch.from_numpy(assign).to(pred_bboxes.device)


def scatter_rows(base: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``base`` (B, nq) with ``val`` (B, M) written at the queries ``idx`` (B, M) where ``valid``; the invalid
    slots write to a throwaway column nq (not to query 0, which a real label may hold)."""
    B, nq = base.shape
    safe = torch.where(valid, idx, nq)
    padded = torch.cat([base, base.new_zeros(B, 1)], 1)
    bi = torch.arange(B, device=base.device)[:, None].expand_as(safe)
    padded = padded.index_put((bi, safe), val.to(base.dtype))
    return padded[:, :nq]


def pair_losses(pred_bboxes: torch.Tensor, pred_scores: torch.Tensor, gt_cls: torch.Tensor,
                gt_bboxes: torch.Tensor, assign: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[class, L1 box, GIoU] losses (gains applied) of one prediction set under ``assign``."""
    B, nq, nc = pred_scores.shape
    num_gt = valid.float().sum().clamp(min=1.0)
    safe_q = assign.clamp(min=0)
    pb = torch.gather(pred_bboxes.float(), 1, safe_q[..., None].expand(-1, -1, 4))  # (B, M, 4)
    gb = gt_bboxes.float()
    vf = valid.float()
    l1 = ((pb - gb).abs() * vf[..., None]).sum() / num_gt
    giou = bbox_iou(pb, gb, xywh=True, GIoU=True).squeeze(-1)
    giou_loss = ((1.0 - giou) * vf).sum() / num_gt
    iou_w = bbox_iou(pb.detach(), gb, xywh=True).squeeze(-1)
    tgt_cls = torch.where(valid, gt_cls.long().clamp(0, nc - 1), nc)
    targets = scatter_rows(torch.full((B, nq), nc, dtype=torch.long, device=pb.device), safe_q, tgt_cls, valid)
    gt_scores = scatter_rows(torch.zeros(B, nq, device=pb.device), safe_q, iou_w, valid)
    one_hot = F.one_hot(targets, nc + 1)[..., :-1].float()
    gt_soft = gt_scores[..., None] * one_hot
    p = torch.sigmoid(pred_scores.float())
    ce = -(gt_soft * torch.log(p + 1e-9) + (1 - gt_soft) * torch.log(1 - p + 1e-9))
    p_t = one_hot * p + (1 - one_hot) * (1 - p)
    alpha_t = one_hot * FL_ALPHA + (1 - one_hot) * (1 - FL_ALPHA)
    fl = alpha_t * (1 - p_t) ** FL_GAMMA * ce
    loss_cls = fl.mean(-1).sum() / (num_gt / nq)
    return torch.stack([loss_cls * CLS_GAIN, l1 * BBOX_GAIN, giou_loss * GIOU_GAIN])


def rtdetr_loss(outputs: Dict, gt_cls: torch.Tensor, gt_bboxes: torch.Tensor,
                gt_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, items [class, bbox, giou]) over every decoder layer, the encoder's queries and the denoising
    groups of the decoder's train-mode ``outputs``."""
    valid = gt_mask > 0
    db, ds = outputs["dec_bboxes"], outputs["dec_scores"]
    dn_meta = outputs.get("dn_meta")
    num_dn = dn_meta["num_dn"] if dn_meta is not None else 0
    totals = torch.zeros(3, device=db.device)
    for i in range(db.shape[0]):
        mb, ms = db[i, :, num_dn:], ds[i, :, num_dn:]
        totals = totals + pair_losses(mb, ms, gt_cls, gt_bboxes, hungarian_match(mb, ms, gt_cls, gt_bboxes, gt_mask),
                                      valid)
    eb, es = outputs["enc_bboxes"], outputs["enc_scores"]
    totals = totals + pair_losses(eb, es, gt_cls, gt_bboxes, hungarian_match(eb, es, gt_cls, gt_bboxes, gt_mask), valid)
    if dn_meta is not None:
        M, G = dn_meta["M"], dn_meta["num_group"]
        ident = torch.where(valid, torch.arange(M, device=db.device)[None, :], -1)
        for i in range(db.shape[0]):
            for g in range(G):
                sl = slice(2 * g * M, 2 * g * M + M)  # the group's positives
                totals = totals + pair_losses(db[i, :, sl], ds[i, :, sl], gt_cls, gt_bboxes, ident, valid) / G
    return totals.sum(), totals
