"""YOLO-NAS (counterpart of ``bsyolo_tpu/models/nas.py``).

``NAS("yolo_nas_s")`` builds the YOLO-NAS graph the JAX package rebuilds from
the public architecture description (``cfg/models/nas/yolo_nas_{s,m,l}.yaml``,
``nn/modules_nas.py``) with seeded weights, as a ``YOLO`` facade: its 17-bin
head goes through the shared decode and NMS (``ModelSpec.reg_max``), predict,
val and train as any detect graph. Published YOLO-NAS ``.pt`` files are pickled
super-gradients modules, which neither package unpickles.

``postprocess_nas`` is the NAS inference contract over already decoded boxes
and class probabilities: NMS on their xywh form, as the reference's
``NASPredictor.postprocess``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

from bsyolo_tpu_torch.ops.boxes import xyxy2xywh
from bsyolo_tpu_torch.ops.nms import non_max_suppression


def postprocess_nas(boxes_xyxy: torch.Tensor, class_scores: torch.Tensor, conf_thres: float = 0.25,
                    iou_thres: float = 0.7, max_det: int = 300) -> torch.Tensor:
    """(B, N, 4) xyxy boxes in input pixels and (B, N, nc) class probabilities -> (B, max_det, 6) x1, y1, x2, y2,
    conf, cls rows, zero-padded."""
    preds = torch.cat([xyxy2xywh(boxes_xyxy.float()), class_scores.float()], -1)
    return non_max_suppression(preds, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det)


def NAS(model: Union[str, Path] = "yolo_nas_s.pt", device: Optional[Union[str, torch.device]] = None, seed: int = 0):
    """A ``YOLO`` facade of the YOLO-NAS graph ``model`` names (``yolo_nas_s``, ``yolo_nas_m``, ``yolo_nas_l`` or a
    YAML path) with weights drawn from ``seed``; a ``.pt`` raises ``NotImplementedError``, as in the JAX package."""
    from bsyolo_tpu_torch.model import YOLO

    p = Path(model)
    if p.suffix == ".pt":
        raise NotImplementedError(
            "YOLO-NAS .pt checkpoints are pickled super-gradients torch modules, which are not unpickled here; build "
            "the reconstructed graph with NAS('yolo_nas_s') (seeded weights)")
    if p.suffix and p.exists():
        return YOLO(str(p), device=device, seed=seed)
    return YOLO(p.name if p.suffix else p.name + ".yaml", device=device, seed=seed)
