"""The YOLO model facade (counterpart of ``bsyolo_tpu/model.py``), detect task.

    from bsyolo_tpu_torch import YOLO
    m = YOLO("yolo11n.yaml")                  # BS-YOLO graph on cuda:0, seeded init
    m = YOLO("yolo11n.yaml").load("w.pt")     # reference torch state_dict
    m = YOLO("runs/detect/train/weights/best.ckpt")  # a checkpoint of either package
    m.train(data="car.yaml", epochs=100, plots=False)  # amp=True (default): the bf16 graph
    metrics = m.val(data="car.yaml", batch=16)
    metrics = m.val(data="car.yaml", half=True)  # the bf16 graph over bf16 weights
    results = m.predict(frames, imgsz=640, batch=8, conf=0.25)
    results = m.predict(frames, augment=True)  # test-time augmentation
    results = m.predict(frames, half=True)     # the bf16 graph over bf16 weights

``half=True`` runs a bfloat16 copy of the graph (``YOLO.half_graph``, built by
``nn.model.cast_inference_graph``: convolution weights cast once and kept until
they or the int8 mode change, BatchNorm statistics float32). After ``train(amp=True)`` the facade holds the
trainer's bf16 graph, so ``predict()`` runs bf16 without ``half``, as the JAX
facade does.

Int8 inference is a mode of the graph, not a predict argument: calibrate
static activation scales on a few float NCHW batches (letterboxed, /255),
turn the mode on, and every predict path runs its convolutions in int8:

    from bsyolo_tpu_torch.nn.modules import set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8
    scales = calibrate_int8(m.model, batches)
    set_int8_inference(m.model, True, scales)    # scales=None: dynamic, per batch
    results = m.predict(frames)
    set_int8_inference(m.model, False)           # float again
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from bsyolo_tpu_torch import select_device
from bsyolo_tpu_torch.cfg import model_yaml_path
from bsyolo_tpu_torch.engine.predictor import DetectionPredictor
from bsyolo_tpu_torch.nn.model import build_model, cast_inference_graph
from bsyolo_tpu_torch.nn.modules import Conv, cast_convs
from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml
from bsyolo_tpu_torch.utils import LOGGER
from bsyolo_tpu_torch.utils.ckpt import load_checkpoint, load_weights, save_checkpoint
from bsyolo_tpu_torch.utils.weights import jax_paths, load_reference_state_dict

_PREDICT_ARGS = {"conf", "iou", "imgsz", "batch", "max_det", "classes", "agnostic_nms", "augment", "verbose", "half"}
# predict options of the JAX package that the port does not have yet -> the ROADMAP item that brings them
_NOT_PORTED = {
    **dict.fromkeys(("vid_stride", "stream_buffer", "save", "save_txt", "save_conf",
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
        suffix = Path(self.model_path).suffix
        if suffix not in (".yaml", ".ckpt", ".pt"):
            raise NotImplementedError(f"{self.model_path}: exported formats are not ported yet (ROADMAP queue 1, "
                                      "item 15); the port loads .yaml graphs, .ckpt checkpoints and .pt weights")
        if suffix == ".pt":
            raise ValueError("a reference .pt carries no graph the port can build; use "
                             "YOLO('<model>.yaml').load('<weights>.pt')")
        self._device = select_device(device)
        self.task = "detect"
        self.metrics = None
        self.trainer = None
        self.ckpt_meta = None
        self._callbacks = None
        self._img_size = 640
        self._half = None  # (key, bf16 inference graph) of half_graph
        if suffix == ".ckpt":
            self._load_ckpt(self.model_path, seed)
        else:
            self._new(self.model_path, seed)

    def _new(self, yaml_name: str, seed: int = 0, nc: Optional[int] = None, names=None):
        d = load_model_yaml(model_yaml_path(yaml_name))
        if nc is not None:
            d["nc"] = nc
        if names:
            d["names"] = dict(enumerate(names))
        self.spec = parse_model_yaml(d, scale=d.get("scale", ""))
        self.model = build_model(self.spec, self._device, seed)

    def _load_ckpt(self, path: str, seed: int = 0):
        """A ``.ckpt`` of either package: the graph of ``meta.args.model`` with the class count and
        names the checkpoint was trained with, its EMA weights (else params) and BatchNorm statistics."""
        payload, meta = load_checkpoint(path)
        args = meta.get("args", {})
        names = meta.get("names") or None  # the trainer's data names; their count is the head's nc
        self._new(args.get("model", "yolo11n.yaml"), seed, nc=len(names) if names else None, names=names)
        load_weights(payload, self.model)
        if str(args.get("imgsz", "")).isdigit():
            self._img_size = int(args["imgsz"])
        self.ckpt_meta = meta

    def load(self, weights: Union[str, Path]) -> "YOLO":
        """Load a reference torch checkpoint (``.pt``: a state_dict or a pickled module) into
        the graph. Parameters the file lacks keep their values, with a warning naming how
        many, and keys the graph lacks are ignored, as in the JAX package."""
        report = self.model.load_state_dict(load_reference_state_dict(weights), strict=False)
        n_missing = sum(not k.endswith("num_batches_tracked") for k in report.missing_keys)
        if n_missing:
            LOGGER.warning(f"weight import: {n_missing} params not found in {weights}")
        return self

    def half_graph(self) -> torch.nn.Module:
        """The bf16 inference graph that predict and val ``half=True`` run (shared, so the two
        cannot diverge), e.g. for ``predict_tiled(m.half_graph(), m.spec, frame)``: built once,
        and again when a convolution weight (by storage and version) or the int8 mode changes;
        the graph runs eagerly, so no input size enters the key."""
        convs = cast_convs(self.model)
        key = (id(self.model), tuple((p.data_ptr(), p._version) for m in convs for p in m.parameters()),
               tuple((m.int8, m.act_absmax) for m in self.model.modules() if isinstance(m, Conv)))
        if self._half is None or self._half[0] != key:
            self._half = (key, cast_inference_graph(self.model))
        return self._half[1]

    @property
    def names(self) -> Dict[int, str]:
        return dict(enumerate(self.spec.names))

    @property
    def device(self) -> torch.device:
        return self._device

    def predict(self, source, stream: bool = False, **kwargs):
        """Detect in ``source`` (a uint8 BGR frame, a list of them, an image file or
        a directory); a list of ``Results``, or a generator with ``stream=True``.
        ``half=True`` runs the bf16 graph over bf16 weights."""
        for k, v in kwargs.items():
            if k in _NOT_PORTED and v:
                raise NotImplementedError(f"predict({k}=...) is not ported yet (ROADMAP {_NOT_PORTED[k]})")
            if k not in _PREDICT_ARGS and k not in _NOT_PORTED:
                raise TypeError(f"predict() got an unexpected keyword argument {k!r}")
        conf = kwargs.get("conf")
        predictor = DetectionPredictor(
            self.half_graph() if kwargs.get("half") else self.model,
            self.spec,
            self._device,
            conf=0.25 if conf is None else conf,
            iou=kwargs.get("iou", 0.7),
            max_det=kwargs.get("max_det", 300),
            imgsz=kwargs.get("imgsz") or self._img_size,
            classes=kwargs.get("classes"),
            agnostic_nms=kwargs.get("agnostic_nms", False),
            names=self.names,
            batch=int(kwargs.get("batch") or 1),
            augment=bool(kwargs.get("augment", False)),
        )
        gen = predictor.stream(source, verbose=kwargs.get("verbose", False))
        return gen if stream else list(gen)

    def __call__(self, source, stream: bool = False, **kwargs):
        return self.predict(source, stream=stream, **kwargs)

    def train(self, **kwargs):
        """Train with ``DetectionTrainer`` (overrides as in ``cfg/default.yaml``; the graph is this
        model's unless ``model=`` names another), on this model's device unless ``device=`` names
        another; then adopt the trained EMA weights and the trainer's graph (the bf16 graph under
        ``amp=True``, the default). Returns the last validation's metrics."""
        from bsyolo_tpu_torch.engine.trainer import DetectionTrainer

        overrides = dict(kwargs)
        overrides.setdefault("model", self.model_path)
        overrides.setdefault("device", str(self._device))
        self.trainer = trainer = DetectionTrainer(overrides=overrides, callbacks=self._callbacks)
        self.metrics = trainer.train()
        # a copy of the trained graph with the EMA weights and the live BatchNorm statistics; the
        # trainer's state keeps its own parameters
        self.spec, self.model, self._device = trainer.spec, copy.deepcopy(trainer.model).eval(), trainer.device
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(trainer.state.ema_params[name])
        self._img_size = trainer.args.imgsz
        return self.metrics

    def val(self, data: Optional[str] = None, batch: int = 16, imgsz: Optional[int] = None, **kwargs):
        """Detection metrics of this model on ``data``'s ``split`` (val by default), letterboxed to
        ``imgsz`` (square, or three aspect buckets with ``rect=True``); NMS at conf 0.001, IoU 0.7
        unless ``conf``, ``iou``, ``max_det`` say otherwise; ``half=True`` on the bf16 graph."""
        from bsyolo_tpu_torch.data import DataLoader, YOLODataset, load_dataset_yaml
        from bsyolo_tpu_torch.engine.trainer import val_batches
        from bsyolo_tpu_torch.engine.validator import DetectionValidator

        for k in ("save_json", "save_txt", "plots"):
            if kwargs.get(k):
                raise NotImplementedError(f"val({k}=True) is not ported yet (ROADMAP queue 1, item 20)")
        data = data or (self.trainer.args.data if self.trainer is not None else None)
        if data is None:
            raise ValueError("val() needs data=<dataset yaml>")
        d = load_dataset_yaml(data)
        split = kwargs.get("split", "val")
        if not d.get(split):
            raise KeyError(f"dataset {data} has no '{split}' split")
        imgsz = imgsz or self._img_size
        single_cls = bool(kwargs.get("single_cls", False))
        ds = YOLODataset(d[split], imgsz=imgsz, augment=False, max_gt=kwargs.get("max_gt", 128), single_cls=single_cls)
        loader = DataLoader(ds, batch, shuffle=False, drop_last=False, rect=bool(kwargs.get("rect", False)))
        vkw = {k: kwargs[k] for k in ("conf", "iou", "max_det") if kwargs.get(k) is not None}
        if kwargs.get("classes"):
            vkw["classes"] = list(kwargs["classes"])
        model = self.half_graph() if kwargs.get("half") else self.model
        validator = DetectionValidator(model, self.spec, names=d.get("names"), single_cls=single_cls,
                                       device=self._device, **vkw)
        self.metrics = validator(None, val_batches(loader, self._device))
        return self.metrics

    def save(self, path: Union[str, Path]) -> Union[str, Path]:
        """Write the current weights as a ``.ckpt`` that ``YOLO()`` of either package loads."""
        from bsyolo_tpu_torch.engine.train_step import init_train_state

        meta = {"args": {"model": self.model_path if Path(self.model_path).suffix == ".yaml" else
                         (self.ckpt_meta or {}).get("args", {}).get("model", "yolo11n.yaml")},
                "epoch": -1, "fitness": 0.0, "names": [str(n) for n in self.spec.names]}
        save_checkpoint(path, init_train_state(self.model), jax_paths(self.model), meta)
        return path

    # --- callbacks ----------------------------------------------------------------------------------
    def add_callback(self, event: str, fn):
        if self._callbacks is None:
            from bsyolo_tpu_torch.utils.callbacks import default_callbacks

            self._callbacks = default_callbacks()
        self._callbacks.add(event, fn)

    def clear_callback(self, event: str):
        if self._callbacks is not None:
            self._callbacks._cbs.pop(event, None)

    def reset_callbacks(self):
        self._callbacks = None

    def track(self, *args, **kwargs):
        raise NotImplementedError("tracking is not ported yet (ROADMAP queue 1, item 11)")

    def export(self, **kwargs):
        raise NotImplementedError("export is not ported yet (ROADMAP queue 1, item 15)")
