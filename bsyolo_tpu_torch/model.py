"""The YOLO model facade (counterpart of ``bsyolo_tpu/model.py``), predict slice.

    from bsyolo_tpu_torch import YOLO
    m = YOLO("yolo11n.yaml")                  # BS-YOLO graph on cuda:0, seeded init
    m = YOLO("yolo11n.yaml").load("w.pt")     # reference torch state_dict
    results = m.predict(frames, imgsz=640, batch=8, conf=0.25)
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import torch

from bsyolo_tpu_torch import select_device
from bsyolo_tpu_torch.cfg import model_yaml_path
from bsyolo_tpu_torch.engine.predictor import DetectionPredictor
from bsyolo_tpu_torch.nn.model import build_model
from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml
from bsyolo_tpu_torch.utils.weights import load_reference_state_dict

_PREDICT_ARGS = {"conf", "iou", "imgsz", "batch", "max_det", "classes", "agnostic_nms", "verbose"}
# predict options of the JAX package that the port does not have yet -> the ROADMAP item that brings them
_NOT_PORTED = {
    **dict.fromkeys(("half", "augment", "vid_stride", "stream_buffer", "save", "save_txt", "save_conf",
                     "save_crop", "show", "visualize", "embed"), "queue 1, item 17"),
    "retina_masks": "queue 1, item 12",
}


class YOLO:
    def __init__(self, model: Union[str, Path] = "yolo11n.yaml", task: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        """Build the graph ``model`` names on ``device`` (``cuda:0`` by default;
        raises when CUDA is absent and no other device is given), with weights
        drawn from ``seed``."""
        if task not in (None, "detect"):
            raise NotImplementedError(f"task {task!r} is not ported yet (ROADMAP queue 1, item 12)")
        self.model_path = str(model)
        if Path(self.model_path).suffix != ".yaml":
            raise NotImplementedError(
                f"{self.model_path}: the port builds graphs from .yaml configs; load reference weights with "
                "YOLO('<model>.yaml').load('<weights>.pt'), other formats come with ROADMAP queue 1, items 10 and 15"
            )
        self._device = select_device(device)
        self.task = "detect"
        d = load_model_yaml(model_yaml_path(self.model_path))
        self.spec = parse_model_yaml(d, scale=d.get("scale", ""))
        self.model = build_model(self.spec, self._device, seed)

    def load(self, weights: Union[str, Path]) -> "YOLO":
        """Load a reference torch state_dict (``.pt``) into the graph, every key matched."""
        self.model.load_state_dict(load_reference_state_dict(weights), strict=True)
        return self

    @property
    def names(self) -> Dict[int, str]:
        return dict(enumerate(self.spec.names))

    @property
    def device(self) -> torch.device:
        return self._device

    def predict(self, source, stream: bool = False, **kwargs):
        """Detect in ``source`` (a uint8 BGR frame, a list of them, an image file or
        a directory); a list of ``Results``, or a generator with ``stream=True``."""
        for k, v in kwargs.items():
            if k in _NOT_PORTED and v:
                raise NotImplementedError(f"predict({k}=...) is not ported yet (ROADMAP {_NOT_PORTED[k]})")
            if k not in _PREDICT_ARGS and k not in _NOT_PORTED:
                raise TypeError(f"predict() got an unexpected keyword argument {k!r}")
        conf = kwargs.get("conf")
        predictor = DetectionPredictor(
            self.model,
            self.spec,
            self._device,
            conf=0.25 if conf is None else conf,
            iou=kwargs.get("iou", 0.7),
            max_det=kwargs.get("max_det", 300),
            imgsz=kwargs.get("imgsz") or 640,
            classes=kwargs.get("classes"),
            agnostic_nms=kwargs.get("agnostic_nms", False),
            names=self.names,
            batch=int(kwargs.get("batch") or 1),
        )
        gen = predictor.stream(source, verbose=kwargs.get("verbose", False))
        return gen if stream else list(gen)

    def __call__(self, source, stream: bool = False, **kwargs):
        return self.predict(source, stream=stream, **kwargs)

    def train(self, **kwargs):
        raise NotImplementedError("training is not ported yet (ROADMAP queue 1, items 6-8 and 10)")

    def val(self, **kwargs):
        raise NotImplementedError("validation is not ported yet (ROADMAP queue 1, item 9)")

    def track(self, *args, **kwargs):
        raise NotImplementedError("tracking is not ported yet (ROADMAP queue 1, item 11)")

    def export(self, **kwargs):
        raise NotImplementedError("export is not ported yet (ROADMAP queue 1, item 15)")
