"""Losses and target assignment (counterpart of ``bsyolo_tpu/losses``)."""

from bsyolo_tpu_torch.losses.classify import classification_loss
from bsyolo_tpu_torch.losses.detect import DetectionLossConfig, LossState, detection_loss, init_loss_state
from bsyolo_tpu_torch.losses.obb import obb_loss, rotated_task_aligned_assign
from bsyolo_tpu_torch.losses.pose import pose_loss
from bsyolo_tpu_torch.losses.segment import segmentation_loss
from bsyolo_tpu_torch.losses.tal import task_aligned_assign

__all__ = ["task_aligned_assign", "DetectionLossConfig", "LossState", "detection_loss", "init_loss_state",
           "segmentation_loss", "pose_loss", "obb_loss", "rotated_task_aligned_assign", "classification_loss"]
