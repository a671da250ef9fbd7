"""Model families beyond the YOLO graph zoo (counterpart of ``bsyolo_tpu/models/``): YOLO-NAS."""

from bsyolo_tpu_torch.models.nas import NAS, postprocess_nas

__all__ = ["NAS", "postprocess_nas"]
