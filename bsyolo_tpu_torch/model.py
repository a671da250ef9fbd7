"""The YOLO model facade (counterpart of ``bsyolo_tpu/model.py``): detect, segment, pose, OBB and classify tasks.

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
    results = m.predict("clip.mp4", vid_stride=2)  # video (OpenCV), webcam "0", "cams.streams"
    results = m.predict("images/", save_txt=True, save_crop=True, project="runs/detect", name="predict")
    vectors = m.embed("images/")               # pooled features of the second-to-last layer, one per image
    metrics = m.val(data="car.yaml", save_json=True, save_txt=True, save_dir="runs/val")
    results = m.track("clip.mp4", persist=True, tracker="bytetrack.yaml")  # boxes carry track ids
    m = YOLO("yolo11n-seg.yaml")               # the task follows the head: results carry masks,
    results = m.predict(frames, retina_masks=True)  # here assembled at each frame's own size
    m = YOLO("yolo11n-pose.yaml")              # results carry keypoints; val gives OKS mAP
    m.train(data="coco8-pose.yaml")           # amp=True (default): the task's bf16 graph, as for Detect
    m = YOLO("yolo11n-obb.yaml")               # results carry rotated boxes (r.obb); val gives probIoU mAP
    m = YOLO("yolo11n-cls.yaml")               # results carry class probabilities (r.probs)
    m.train(data="<root with train/ and val/ class folders>", imgsz=224)  # top-1 / top-5

``half=True`` runs a bfloat16 copy of the graph (``YOLO.half_graph``, built by
``nn.model.cast_inference_graph``: convolution weights cast once and kept until
they or the int8 mode change, BatchNorm statistics float32). After ``train(amp=True)`` the facade holds the
trainer's bf16 graph, so ``predict()`` runs bf16 without ``half``, as the JAX
facade does. Both serve every task graph (Proto's transposed convolution and
Classify's linear layer compute in bfloat16 too).

Int8 inference is a mode of the graph, not a predict argument: calibrate
static activation scales on a few float NCHW batches (letterboxed, /255),
turn the mode on, and every predict and val path runs its convolutions in int8,
on every task graph (the quantized set is the JAX package's: each ``Conv`` with
groups 1, Proto's and Classify's included):

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
from bsyolo_tpu_torch.nn.parser import HEAD_TASKS, load_model_yaml, parse_model_yaml
from bsyolo_tpu_torch.utils import LOGGER
from bsyolo_tpu_torch.utils.ckpt import load_checkpoint, load_weights, save_checkpoint
from bsyolo_tpu_torch.utils.weights import jax_paths, load_reference_state_dict

_PREDICT_ARGS = {"conf", "iou", "imgsz", "batch", "max_det", "classes", "agnostic_nms", "augment", "verbose", "half",
                 "vid_stride", "stream_buffer", "save_txt", "save_conf", "save_crop", "embed", "project", "name",
                 "retina_masks"}
# predict options of the JAX package that the port does not have yet -> the ROADMAP item that brings them
_NOT_PORTED = {
    **dict.fromkeys(("save", "show"), "queue 1, item 25"),
    "visualize": "queue 1, item 16",
}


def result_stem(path: str, i: int) -> str:
    """The file stem of result ``i``'s outputs: ``clip_frame<n>`` for a video frame
    (``clip.mp4#frame<n>``), ``image<i>`` for an array, else the source file's stem."""
    raw = str(path)
    if "#" in raw:
        base, _, fr = raw.partition("#")
        return f"{Path(base).stem}_{fr}"
    if raw == "array":
        return f"image{i}"
    return Path(raw).stem


class YOLO:
    def __init__(self, model: Union[str, Path] = "yolo11n.yaml", task: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        """Build the graph ``model`` names on ``device`` (``cuda:0`` by default;
        raises when CUDA is absent and no other device is given), with weights
        drawn from ``seed``."""
        if task is not None and task not in HEAD_TASKS.values():
            raise ValueError(f"unknown task {task!r}: one of {sorted(HEAD_TASKS.values())}")
        self.model_path = str(model)
        suffix = Path(self.model_path).suffix
        if suffix not in (".yaml", ".ckpt", ".pt"):
            raise NotImplementedError(f"{self.model_path}: exported formats are not ported yet (ROADMAP queue 1, "
                                      "item 15); the port loads .yaml graphs, .ckpt checkpoints and .pt weights")
        if suffix == ".pt":
            raise ValueError("a reference .pt carries no graph the port can build; use "
                             "YOLO('<model>.yaml').load('<weights>.pt')")
        self._device = select_device(device)
        self.metrics = None
        self.trainer = None
        self.ckpt_meta = None
        self._callbacks = None
        self._img_size = 640
        self._half = None  # (key, bf16 inference graph) of half_graph
        self._tracker = None  # the tracker that track(persist=True) goes on with
        self.predictor = None  # the last predict()'s DetectionPredictor (its reader_wait and wall seconds)
        if suffix == ".ckpt":
            self._load_ckpt(self.model_path, seed)
        else:
            self._new(self.model_path, seed)
        if task is not None and task != self.spec.task:
            raise ValueError(f"task={task!r}, but {self.model_path} has a {self.spec.head.module} head "
                             f"(task {self.spec.task!r})")

    @property
    def task(self) -> str:
        """detect, segment, pose, obb or classify: the graph's head decides."""
        return self.spec.task

    def _new(self, yaml_name: str, seed: int = 0, nc: Optional[int] = None, names=None, kpt_shape=None):
        d = load_model_yaml(model_yaml_path(yaml_name))
        if nc is not None:
            d["nc"] = nc
        if names:
            d["names"] = dict(enumerate(names))
        if kpt_shape:
            d["kpt_shape"] = list(kpt_shape)
        self.spec = parse_model_yaml(d, scale=d.get("scale", ""))
        self.model = build_model(self.spec, self._device, seed)

    def _load_ckpt(self, path: str, seed: int = 0):
        """A ``.ckpt`` of either package: the graph of ``meta.args.model`` with the class count and
        names the checkpoint was trained with (and the port's ``kpt_shape``), its EMA weights (else
        params) and BatchNorm statistics; a ``task`` recorded in the meta must be the graph's."""
        payload, meta = load_checkpoint(path)
        args = meta.get("args", {})
        names = meta.get("names") or None  # the trainer's data names; their count is the head's nc
        self._new(args.get("model", "yolo11n.yaml"), seed, nc=len(names) if names else None, names=names,
                  kpt_shape=meta.get("kpt_shape"))
        if meta.get("task", self.spec.task) != self.spec.task:
            raise ValueError(f"{path} was trained as a {meta['task']} model, but its graph "
                             f"{args.get('model')} has a {self.spec.head.module} head")
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
        """Detect in ``source`` (a uint8 BGR frame, a list of them, an image file, a directory,
        a glob, a video file or URL, a webcam index or a ``.streams`` list; video through OpenCV);
        a list of ``Results``, or a generator with ``stream=True``. ``half=True`` runs the bf16
        graph over bf16 weights; ``vid_stride`` keeps every n-th video frame, ``stream_buffer``
        keeps every stream frame (else the latest). ``save_txt`` (with ``save_conf``) writes
        ``<project>/<name>/labels/<stem>.txt`` and ``save_crop`` ``<project>/<name>/crops/<class>/
        <stem>_<i>.jpg`` (``runs/detect/predict`` by default; not with ``stream=True``). ``embed`` is
        accepted and changes nothing, as in the JAX facade: ``embed()`` gives the vectors.
        A Segment graph's results carry masks at each frame's size (``retina_masks=True``: assembled
        from the prototypes at that size, on the host); a Pose graph's carry keypoints, an OBB graph's
        rotated boxes (``Results.obb``), a Classify graph's class probabilities (``Results.probs``).
        ``half`` and int8 serve every graph; ``augment`` on a task graph warns and predicts at one
        scale, as in the JAX package."""
        for k, v in kwargs.items():
            if k in _NOT_PORTED and v:
                raise NotImplementedError(f"predict({k}=...) is not ported yet (ROADMAP {_NOT_PORTED[k]})")
            if k not in _PREDICT_ARGS and k not in _NOT_PORTED:
                raise TypeError(f"predict() got an unexpected keyword argument {k!r}")
        if kwargs.get("retina_masks") and self.task != "segment":
            raise NotImplementedError(f"predict(retina_masks=True) assembles the masks of a Segment graph; this graph "
                                      f"has a {self.spec.head.module} head")
        conf = kwargs.get("conf")
        self.predictor = predictor = DetectionPredictor(
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
            stream_buffer=bool(kwargs.get("stream_buffer", False)),
            retina_masks=bool(kwargs.get("retina_masks", False)),
        )
        gen = predictor.stream(source, vid_stride=int(kwargs.get("vid_stride") or 1),
                               verbose=kwargs.get("verbose", False))
        if stream:
            return gen
        results = list(gen)
        if kwargs.get("save_txt") or kwargs.get("save_crop"):
            out_dir = Path(kwargs.get("project") or "runs/detect") / (kwargs.get("name") or "predict")
            for i, r in enumerate(results):
                stem = result_stem(r.path, i)
                if kwargs.get("save_txt"):
                    r.save_txt(out_dir / "labels" / f"{stem}.txt", save_conf=bool(kwargs.get("save_conf", False)))
                if kwargs.get("save_crop"):
                    r.save_crop(out_dir / "crops", file_name=stem)
        return results

    def embed(self, source, stream: bool = False, embed=None, imgsz: Optional[int] = None):
        """One 1-D float32 vector per image of ``source`` (sources as ``predict``): the global-average
        pooled outputs of the ``embed`` layers, concatenated (the second-to-last layer by default),
        of the image letterboxed on the host (``letterbox_image``, as the JAX package's embed) and run
        on this model's device. A list, or a generator with ``stream=True``."""
        import numpy as np

        from bsyolo_tpu_torch.engine.predictor import iter_source
        from bsyolo_tpu_torch.ops.letterbox import letterbox_image

        idxs = tuple(embed or (len(self.spec.layers) - 2,))
        size = imgsz or self._img_size

        def gen():
            for frame, _ in iter_source(source):
                lb = letterbox_image(frame, (size, size))[0]
                x = torch.from_numpy(np.ascontiguousarray(lb[..., ::-1].transpose(2, 0, 1)))[None]
                with torch.inference_mode():
                    v = self.model(x.to(self._device).float() / 255.0, embed=idxs)[0].float().cpu().numpy()
                yield v

        return gen() if stream else list(gen())

    def __call__(self, source, stream: bool = False, **kwargs):
        return self.predict(source, stream=stream, **kwargs)

    def train(self, **kwargs):
        """Train with ``DetectionTrainer`` (``ClassificationTrainer`` for a Classify graph, ``data`` its
        folder-per-class root; overrides as in ``cfg/default.yaml``; the graph is this model's unless
        ``model=`` names another), on this model's device unless ``device=`` names another; then adopt
        the trained EMA weights and the trainer's graph (the bf16 graph under ``amp=True``, the
        default). Returns the last validation's metrics."""
        from bsyolo_tpu_torch.engine.classify import ClassificationTrainer
        from bsyolo_tpu_torch.engine.trainer import DetectionTrainer

        overrides = dict(kwargs)
        overrides.setdefault("model", self.model_path)
        overrides.setdefault("device", str(self._device))
        trainer_cls = ClassificationTrainer if self.task == "classify" else DetectionTrainer
        self.trainer = trainer = trainer_cls(overrides=overrides, callbacks=self._callbacks)
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
        """Metrics of this model on ``data``'s ``split`` (val by default), letterboxed to ``imgsz``
        (square, or three aspect buckets with ``rect=True``, detect only); NMS at conf 0.001, IoU 0.7
        unless ``conf``, ``iou``, ``max_det`` say otherwise; ``half=True`` on the bf16 graph. Box mAP,
        and mask mAP for a Segment graph (``SegmentMetrics``), OKS keypoint mAP for a Pose graph
        (``PoseMetrics``), probIoU mAP for an OBB graph (``OBBValidator``); top-1 and top-5 accuracy of a
        Classify graph on the ``val`` (else ``test``) class folders of the root ``data``
        (``ClassifyMetrics``).
        ``save_json`` writes ``<save_dir>/predictions.json`` (COCO results, the official category ids
        for a COCO set of 80 classes), ``save_txt`` (with ``save_conf``) ``<save_dir>/labels/<stem>.txt``
        per image, in original-image pixels; ``save_dir`` is ``runs/val`` by default."""
        from bsyolo_tpu_torch.data import DataLoader, YOLODataset, load_dataset_yaml
        from bsyolo_tpu_torch.engine.trainer import val_batches
        from bsyolo_tpu_torch.engine.validator import (DetectionValidator, OBBValidator, PoseValidator,
                                                       SegmentationValidator)

        if kwargs.get("plots"):
            raise NotImplementedError("val(plots=True) is not ported yet (ROADMAP queue 1, item 16)")
        data = data or (self.trainer.args.data if self.trainer is not None else None)
        if data is None:
            raise ValueError("val() needs data=<dataset yaml>")
        if self.task == "classify":
            return self._val_classify(data, batch, imgsz or self._img_size, **kwargs)
        d = load_dataset_yaml(data)
        split = kwargs.get("split", "val")
        if not d.get(split):
            raise KeyError(f"dataset {data} has no '{split}' split")
        imgsz = imgsz or self._img_size
        single_cls = bool(kwargs.get("single_cls", False))
        task = self.task
        ds = YOLODataset(d[split], imgsz=imgsz, augment=False, max_gt=kwargs.get("max_gt", 128), single_cls=single_cls,
                         task=task, flip_idx=d.get("flip_idx"))
        rect = bool(kwargs.get("rect", False))
        if rect and task != "detect":
            LOGGER.warning("rect val is detect-only; using the square letterbox")
            rect = False
        loader = DataLoader(ds, batch, shuffle=False, drop_last=False, rect=rect)
        vkw = {k: kwargs[k] for k in ("conf", "iou", "max_det") if kwargs.get(k) is not None}
        if kwargs.get("classes"):
            vkw["classes"] = list(kwargs["classes"])
        save_dir = kwargs.get("save_dir") or "runs/val"
        if kwargs.get("save_txt") and task != "detect":
            LOGGER.warning(f"val(save_txt=True) writes detect labels only, as in the JAX package; nothing is written "
                           f"for the {task} task")
        elif kwargs.get("save_txt"):
            vkw.update(save_txt=True, save_conf=bool(kwargs.get("save_conf", False)), save_dir=save_dir)
        if kwargs.get("save_json"):
            from bsyolo_tpu_torch.utils.coco import COCO80_TO_COCO91

            coco = "coco" in str(data).lower() and self.spec.nc == 80  # official COCO category ids
            vkw.update(save_json=True, save_dir=save_dir, class_map=COCO80_TO_COCO91 if coco else None)
        model = self.half_graph() if kwargs.get("half") else self.model
        validator_cls = {"segment": SegmentationValidator, "pose": PoseValidator, "obb": OBBValidator}.get(
            task, DetectionValidator)
        validator = validator_cls(model, self.spec, names=d.get("names"), single_cls=single_cls, device=self._device,
                                  **vkw)
        self.metrics = validator(None, val_batches(loader, self._device), im_files=ds.img_files)
        return self.metrics

    def _val_classify(self, data, batch: int, imgsz: int, **kwargs):
        from bsyolo_tpu_torch.data.classify import ClassificationDataset, ClassifyLoader
        from bsyolo_tpu_torch.engine.classify import ClassificationValidator, val_root

        ds = ClassificationDataset(val_root(data), imgsz=imgsz, augment=False,
                                   crop_fraction=float(kwargs.get("crop_fraction", 1.0) or 1.0))
        model = self.half_graph() if kwargs.get("half") else self.model
        self.metrics = ClassificationValidator(model, self._device)(
            None, ClassifyLoader(ds, batch, shuffle=False, drop_last=False))
        return self.metrics

    def save(self, path: Union[str, Path]) -> Union[str, Path]:
        """Write the current weights as a ``.ckpt`` that ``YOLO()`` of either package loads."""
        from bsyolo_tpu_torch.engine.train_step import init_train_state

        meta = {"args": {"model": self.model_path if Path(self.model_path).suffix == ".yaml" else
                         (self.ckpt_meta or {}).get("args", {}).get("model", "yolo11n.yaml")},
                "epoch": -1, "fitness": 0.0, "names": [str(n) for n in self.spec.names], "task": self.task,
                "kpt_shape": list(self.spec.kpt_shape)}
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

    def track(self, source, persist: bool = False, tracker: Optional[str] = None, stream: bool = False, **kwargs):
        """Detect as ``predict`` does (``conf`` 0.1 unless given) and track across the frames: each
        ``Results``' boxes carry their track id (7 columns: x1, y1, x2, y2, id, conf, cls). ``tracker``
        is a tracker YAML (``bytetrack.yaml``, ``botsort.yaml`` or a path; the cfg's ``tracker`` key by
        default); ``persist=True`` goes on with the tracker of the last call, else a new one starts.
        A list in, a list out; ``stream=True`` or a stream source read lazily, a generator."""
        from bsyolo_tpu_torch.cfg import DEFAULT_CFG_DICT
        from bsyolo_tpu_torch.trackers import create_tracker, track_results

        if not persist or self._tracker is None:
            self._tracker = create_tracker(tracker or DEFAULT_CFG_DICT.get("tracker") or "botsort.yaml")
        kwargs.setdefault("conf", 0.1)  # the reference's track default
        results = self.predict(source, stream=stream, **kwargs)
        if isinstance(results, list):
            return [track_results(self._tracker, r) for r in results]
        return (track_results(self._tracker, r) for r in results)

    def export(self, **kwargs):
        raise NotImplementedError("export is not ported yet (ROADMAP queue 1, item 15)")
