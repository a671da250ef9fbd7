"""Oriented-box geometry: probIoU, rotated NMS, corner conversion (counterpart of ``bsyolo_tpu/ops/obb.py``).

Boxes are xywhr: centre, width, height in pixels and the angle in radians.
probIoU compares the Gaussians of two boxes (covariance ``diag(w^2, h^2) / 12``
rotated by r) through their Bhattacharyya distance. ``nms_rotated`` keeps the
JAX package's fixed shapes: the ``pre_k`` best anchors, greedy suppression on
probIoU within a class (``ops/nms.py _greedy_keep``), (B, max_det, 7) rows of
x, y, w, h, conf, cls, angle padded with zeros and class -1. Rankings are
stable descending sorts, the tie order of ``jax.lax.top_k``.
"""

from __future__ import annotations

import math

import torch

from bsyolo_tpu_torch.ops.nms import _greedy_keep, _top_k


def _get_covariance_matrix(obb: torch.Tensor):
    """(a, b, c) covariance terms, each (..., 1), of xywhr boxes."""
    w, h, r = obb[..., 2:3], obb[..., 3:4], obb[..., 4:5]
    a, b = w**2 / 12.0, h**2 / 12.0
    cos, sin = torch.cos(r), torch.sin(r)
    cos2, sin2 = cos**2, sin**2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """probIoU of broadcastable xywhr boxes, (..., 1). The square root of the two determinants'
    product is floored at eps^2, so a zero-area box (a padding row) has a finite gradient."""
    x1, y1 = obb1[..., 0:1], obb1[..., 1:2]
    x2, y2 = obb2[..., 0:1], obb2[..., 1:2]
    a1, b1, c1 = _get_covariance_matrix(obb1)
    a2, b2, c2 = _get_covariance_matrix(obb2)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    u = (a1 * b1 - c1**2).clamp(min=0)
    v = (a2 * b2 - c2**2).clamp(min=0)
    t3 = torch.log(((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
                   / (4 * torch.sqrt(torch.clamp(u * v, min=eps * eps)) + eps) + eps) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    iou = 1.0 - hd
    if CIoU:
        w1, h1 = obb1[..., 2:3], obb1[..., 3:4]
        w2, h2 = obb2[..., 2:3], obb2[..., 3:4]
        v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - v * alpha
    return iou


def batch_probiou(obb1: torch.Tensor, obb2: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) pairwise probIoU."""
    return probiou(obb1[:, None, :], obb2[None, :, :])[..., 0]


def nms_rotated(prediction: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45, max_det: int = 300,
                pre_k: int = 512, nc: int = 0) -> torch.Tensor:
    """(B, A, 4 + nc + 1) decoded rows (xywh, scores, angle; ``decode_obb``) -> (B, min(max_det, pre_k, A), 7)
    kept rows x, y, w, h, conf, cls, angle, best first; padding rows are zeros with class -1."""
    pred = prediction.float()
    nc = nc if nc > 0 else pred.shape[-1] - 5
    B, A, _ = pred.shape
    scores = pred[..., 4 : 4 + nc]
    best, cls = scores.max(-1)
    k = min(pre_k, A)
    cand_scores, idx = _top_k(best, k)  # (B, k)
    valid = cand_scores > conf_thres
    rows = torch.gather(pred, 1, idx[..., None].expand(B, k, pred.shape[-1]))
    cand = torch.cat([rows[..., :4], rows[..., 4 + nc : 5 + nc]], -1)  # (B, k, 5)
    ccls = torch.gather(cls, 1, idx)
    iou = probiou(cand[:, :, None, :], cand[:, None, :, :])[..., 0]
    same = ccls[:, :, None] == ccls[:, None, :]
    keep = _greedy_keep(torch.where(same, iou, 0.0), valid, iou_thres)
    ks = torch.where(keep, cand_scores, -1.0)
    top, oidx = _top_k(ks, min(max_det, k))
    ok = top > 0
    sel = torch.gather(cand, 1, oidx[..., None].expand(*oidx.shape, 5))
    okf = ok[..., None].float()
    out = torch.cat([sel[..., :4] * okf, torch.where(ok, top, 0.0)[..., None],
                     torch.where(ok, torch.gather(ccls, 1, oidx).float(), -1.0)[..., None], sel[..., 4:5] * okf], -1)
    return out


def xywhr2xyxyxyxy(obb: torch.Tensor) -> torch.Tensor:
    """xywhr -> the 4 corner points (..., 4, 2): centre + (w/2 along r) + (h/2 across r), in turn."""
    c, w, h, r = obb[..., 0:2], obb[..., 2:3], obb[..., 3:4], obb[..., 4:5]
    cos, sin = torch.cos(r), torch.sin(r)
    dx1 = torch.cat([w / 2 * cos, w / 2 * sin], -1)
    dy1 = torch.cat([-h / 2 * sin, h / 2 * cos], -1)
    return torch.stack([c + dx1 + dy1, c + dx1 - dy1, c - dx1 - dy1, c - dx1 + dy1], -2)
