"""Detect postprocess: raw head maps -> (B, max_det, 6) boxes
(counterpart of ``bsyolo_tpu/kernels/postprocess.py``).

    [CUDA]    DFL box decode -> xyxy pixels, fused with the per-anchor max
              class logit (kernels/decode.py); its plain version on the CPU
    [PyTorch] top-k candidates on raw logits, sigmoid on the survivors only,
              greedy fixed-point NMS (ops/nms.py)
"""

from __future__ import annotations

from typing import Sequence

import torch

from bsyolo_tpu_torch.kernels.decode import REG_MAX, box_best, box_best_reference
from bsyolo_tpu_torch.nn.heads import flatten_levels
from bsyolo_tpu_torch.ops.anchors import make_anchors
from bsyolo_tpu_torch.ops.nms import nms_from_logits


def detect_postprocess(
    feats: Sequence[torch.Tensor],
    strides: Sequence[int],
    nc: int,
    conf_thres: float = 0.25,
    iou_thres: float = 0.7,
    max_det: int = 300,
    pre_k: int = 1024,
    multi_label: bool = True,
    agnostic: bool = False,
    return_idx: bool = False,
    reg_max: int = REG_MAX,
):
    """Per-level (B, 4 * reg_max + nc, H, W) Detect maps -> (B, max_det, 6)
    x1, y1, x2, y2, conf, cls (+ (B, max_det) source anchor indices).

    The decode is the CUDA kernel for a CUDA tensor and its plain version for a
    CPU tensor. The kernel is specialised to 16 DFL bins, so ``reg_max != 16``
    decodes with the plain version on either device, as in the JAX package.
    """
    anchors, stride_t = make_anchors([f.shape[2:] for f in feats], strides, 0.5, device=feats[0].device)
    flat = flatten_levels(feats).float()  # (B, no, A), contiguous
    if reg_max == REG_MAX:
        boxes, best = box_best(flat, anchors, stride_t, nc)
    else:
        boxes, best = box_best_reference(flat, anchors, stride_t, nc, reg_max)
    cls_logits = flat[:, 4 * reg_max : 4 * reg_max + nc].transpose(1, 2)  # (B, A, nc) view
    return nms_from_logits(
        boxes,
        cls_logits,
        best,
        conf_thres=conf_thres,
        iou_thres=iou_thres,
        max_det=max_det,
        pre_k=pre_k,
        multi_label=multi_label,
        agnostic=agnostic,
        return_idx=return_idx,
    )
