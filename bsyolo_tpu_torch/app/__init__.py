"""Blind-sidewalk illegal-parking application (counterpart of ``bsyolo_tpu/app``; reference sys/).

GRFB-UNet tactile-paving segmentation + YOLO+ByteTrack vehicle tracking +
occlusion-ratio/dwell-time violation rule.
"""

from bsyolo_tpu_torch.app.grfb_unet import GRFBUNet, BlindwaySegmenter
from bsyolo_tpu_torch.app.violation import VehicleTimer, is_parking_violation, occlusion_ratio
from bsyolo_tpu_torch.app.background import extract_static_background
from bsyolo_tpu_torch.app.pipeline import ParkingViolationPipeline

__all__ = [
    "GRFBUNet",
    "BlindwaySegmenter",
    "VehicleTimer",
    "is_parking_violation",
    "occlusion_ratio",
    "extract_static_background",
    "ParkingViolationPipeline",
]
