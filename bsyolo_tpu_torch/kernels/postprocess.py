"""Detect postprocess: raw head maps -> (B, max_det, 6) boxes
(counterpart of ``bsyolo_tpu/kernels/postprocess.py``).

    [CUDA]    DFL box decode of the per-level maps, read in place -> xyxy
              pixels, the per-anchor max class logit and the class logits
              anchors-first, in one launch (kernels/decode.py); its plain
              version on the CPU
    [PyTorch] top-k candidates on raw logits, sigmoid on the survivors only,
              greedy fixed-point NMS (ops/nms.py)
"""

from __future__ import annotations

from typing import Sequence

import torch

from bsyolo_tpu_torch.kernels.decode import REG_MAX, box_best
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

    The decode is one launch of the CUDA kernel for CUDA maps, which reads the
    levels in place, and its plain version for CPU maps. The kernel is specialised to 16 DFL bins, so ``reg_max != 16``
    decodes with the plain version on either device, as in the JAX package.
    """
    boxes, best, cls_logits = box_best(feats, strides, nc, reg_max)
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
