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
    results = m.predict("clip.mp4", save=True, save_frames=True)  # runs/detect/predict/clip.mp4, clip_<n>.jpg
    results = m.predict(frames, show=True)     # cv2.imshow where there is a display
    m.fuse()                                   # returns m, as the JAX facade's
    m.info()                                   # {"layers": ..., "parameters": ...}
    m.reset_weights()                          # the seeded init again
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
    m = YOLO("yolov8n.yaml")                   # the YOLO v3, v5, v6, v8, v9 and v10 graphs of every task:
    m = YOLO("yolov9t.yaml")                   # yolov3-tiny.yaml, yolov5n-p6.yaml, yolov6n.yaml (ReLU),
    m = YOLO("yolov8n-seg.yaml")               # yolov8n-p2.yaml, yolov8n-cls-resnet50.yaml, yolov9e-seg.yaml, ...
    m = YOLO("yolov10n.yaml")                  # NMS-free: predict and val take the one-to-one head's top rows;
    m.train(data="car.yaml")                   # train() runs the end-to-end loss (one-to-many + one-to-one)
    m = RTDETR("rtdetr-l.yaml")                # RT-DETR (also YOLO("rtdetr-x.yaml"), "rtdetr-resnet50.yaml",
    m.train(data="car.yaml")                   # "yolov8-rtdetr.yaml"): NMS-free, the Hungarian-matched DETR loss
    m = YOLOWorld("yolov8s-world.yaml")        # open vocabulary (also "yolov8s-worldv2.yaml"): classes are text rows
    m.set_classes(["person", "bus"])           # hashed n-gram text (not CLIP), or embeddings=(K, 512) | {name: vec} | .npz
    m.train(data="car.yaml", text_embeddings=None)  # the data's class names as text; txt_feats go into each .ckpt
    m = NAS("yolo_nas_s")                      # YOLO-NAS (bsyolo_tpu_torch.models.nas): a YOLO facade, 17-bin head

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
import dataclasses
import os
import sys
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from bsyolo_tpu_torch import select_device
from bsyolo_tpu_torch.cfg import model_yaml_path
from bsyolo_tpu_torch.engine.predictor import DetectionPredictor
from bsyolo_tpu_torch.nn.model import bind_text, build_model, cast_inference_graph, count_params
from bsyolo_tpu_torch.nn.modules import Conv, cast_convs
from bsyolo_tpu_torch.nn.parser import HEAD_TASKS, load_model_yaml, parse_model_yaml
from bsyolo_tpu_torch.utils import CV2_DRAWING, CV2_VIDEO, LOGGER, import_cv2
from bsyolo_tpu_torch.utils.ckpt import load_checkpoint, load_weights, save_checkpoint
from bsyolo_tpu_torch.utils.text_embed import world_text
from bsyolo_tpu_torch.utils.weights import jax_paths, load_reference_state_dict

_PREDICT_ARGS = {"conf", "iou", "imgsz", "batch", "max_det", "classes", "agnostic_nms", "augment", "verbose", "half",
                 "vid_stride", "stream_buffer", "save", "save_frames", "save_txt", "save_conf", "save_crop", "show",
                 "show_labels", "show_conf", "show_boxes", "line_width", "embed", "project", "name", "retina_masks"}
# predict options of the JAX package that the port does not have yet -> the ROADMAP item that brings them
_NOT_PORTED = {"visualize": "queue 1, item 16"}


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
        from bsyolo_tpu_torch.engine.backend import AutoBackend, artifact_kind

        self.model_path = str(model)
        suffix = Path(self.model_path).suffix
        kind = artifact_kind(self.model_path)
        if suffix in (".stablehlo", ".stablehlo-int8", ".tflite") or self.model_path.endswith(".stablehlo-int8"):
            raise ValueError(f"{self.model_path} is a JAX package artifact (bsyolo_tpu); the port's artifacts are .pt2, "
                             ".pt2-int8 and .onnx (YOLO.export(format='pt2'))")
        if suffix not in (".yaml", ".ckpt", ".pt") and kind not in ("pt2", "onnx"):
            raise ValueError(f"{self.model_path}: the port loads .yaml graphs, .ckpt checkpoints, .pt weights and "
                             ".pt2, .pt2-int8 and .onnx artifacts")
        if suffix == ".pt":
            raise ValueError("a reference .pt carries no graph the port can build; use "
                             "YOLO('<model>.yaml').load('<weights>.pt')")
        self._device = select_device(device) if kind != "onnx" else torch.device("cpu")
        # an exported artifact (reference YOLO("best.onnx")): predict and val run it through AutoBackend
        self._artifact = self.model_path if kind in ("pt2", "onnx") else None
        self._backend = None
        self.artifact_meta = AutoBackend._load_meta(Path(self.model_path)) if self._artifact else {}
        self.metrics = None
        self.trainer = None
        self.ckpt_meta = None
        self._callbacks = None
        self._img_size = 640
        self._seed = seed
        self._half = None  # (key, bf16 inference graph) of half_graph
        self._tracker = None  # the tracker that track(persist=True) goes on with
        self.predictor = None  # the last predict()'s DetectionPredictor (its reader_wait and wall seconds)
        self.txt_feats = None  # a YOLO-World graph's bound text, (1, K, 512) float32 (None: the placeholder)
        if self._artifact:
            self.spec = self.model = None
            self._img_size = int(self.artifact_meta.get("imgsz") or 640)
        elif suffix == ".ckpt":
            self._load_ckpt(self.model_path, seed)
        else:
            self._new(self.model_path, seed)
        if task is not None and task != self.task:
            raise ValueError(f"task={task!r}, but {self.model_path} has a {self.spec.head.module} head "
                             f"(task {self.spec.task!r})")

    @property
    def task(self) -> str:
        """detect, segment, pose, obb or classify: the graph's head decides (an artifact's sidecar)."""
        return self.spec.task if self.spec is not None else self.artifact_meta.get("task", "detect")

    def _need_graph(self, what: str) -> None:
        if self._artifact:
            raise ValueError(f"{what} needs the live graph; {self._artifact} is an exported artifact (it predicts and "
                             "validates): rebuild from the .yaml/.ckpt")

    def backend(self):
        """The ``AutoBackend`` of this facade's artifact (``YOLO("x.pt2")``), loaded once."""
        from bsyolo_tpu_torch.engine.backend import AutoBackend

        if self._backend is None:
            self._backend = AutoBackend(self._artifact, self._img_size, device=self._device)
        return self._backend

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
        params) and BatchNorm statistics; a ``task`` recorded in the meta must be the graph's. The graph
        is built at the meta's ``graph_nc`` where it has one (the port's), else at the names' count. A
        YOLO-World checkpoint's ``txt_feats`` are bound to the graph, the text it was trained against, and
        its K rows are the classes (after ``set_classes`` K need not be the graph's class count)."""
        payload, meta = load_checkpoint(path)
        args = meta.get("args", {})
        names = meta.get("names") or None  # the trainer's data names; their count is the head's nc
        tf = payload.get("txt_feats")
        if tf is not None and not names:
            names = [str(i) for i in range(np.asarray(tf).shape[1])]
        nc = meta.get("graph_nc") or (len(names) if names else None)
        self._new(args.get("model", "yolo11n.yaml"), seed, nc=nc, names=names if names and len(names) == nc else None,
                  kpt_shape=meta.get("kpt_shape"))
        if meta.get("task", self.spec.task) != self.spec.task:
            raise ValueError(f"{path} was trained as a {meta['task']} model, but its graph "
                             f"{args.get('model')} has a {self.spec.head.module} head")
        load_weights(payload, self.model)
        if tf is not None:
            self.txt_feats = np.asarray(tf, np.float32)
            bind_text(self.model, self.txt_feats)
            self.spec = dataclasses.replace(self.spec, nc=len(names), names=tuple(names))
        if str(args.get("imgsz", "")).isdigit():
            self._img_size = int(args["imgsz"])
        self.ckpt_meta = meta

    def load(self, weights: Union[str, Path]) -> "YOLO":
        """Load a reference torch checkpoint (``.pt``: a state_dict or a pickled module) into
        the graph. Parameters the file lacks keep their values, with a warning naming how
        many, and keys the graph lacks are ignored, as in the JAX package."""
        self._need_graph("load")
        report = self.model.load_state_dict(load_reference_state_dict(weights), strict=False)
        n_missing = sum(not k.endswith("num_batches_tracked") for k in report.missing_keys)
        if n_missing:
            LOGGER.warning(f"weight import: {n_missing} params not found in {weights}")
        return self

    def half_graph(self) -> torch.nn.Module:
        """The bf16 inference graph that predict and val ``half=True`` run (shared, so the two
        cannot diverge), e.g. for ``predict_tiled(m.half_graph(), m.spec, frame)``: built once,
        and again when a convolution weight (by storage and version) or the int8 mode changes;
        the graph runs eagerly, so no input size enters the key; a YOLO-World graph's copy shares its text,
        and a new text (``set_classes``) makes a new copy."""
        self._need_graph("half_graph")
        convs = cast_convs(self.model)
        text = getattr(self.model, "txt_feats", None)
        key = (id(self.model), tuple((p.data_ptr(), p._version) for m in convs for p in m.parameters()),
               tuple((m.int8, m.act_absmax) for m in self.model.modules() if isinstance(m, Conv)),
               None if text is None else (text.data_ptr(), text._version))
        if self._half is None or self._half[0] != key:
            self._half = (key, cast_inference_graph(self.model))
        return self._half[1]

    def fuse(self) -> "YOLO":
        """Returns ``self``, as the JAX facade's ``fuse`` does (kept for API parity): the BatchNorm of
        each ``Conv`` stays a separate per-channel affine."""
        self._need_graph("fuse")
        return self

    def reset_weights(self) -> "YOLO":
        """Draw the weights again from the seed this facade was built with (the graph rebuilt from its
        spec, float32) and drop the cached predictor and bf16 graph. Returns ``self``."""
        self._need_graph("reset_weights")
        self.model = build_model(self.model.spec, self._device, self._seed)
        if self.txt_feats is not None:
            bind_text(self.model, self.txt_feats)
        self._half = self.predictor = None
        return self

    def info(self) -> Dict[str, int]:
        """The graph's layer count and parameter count (BatchNorm's running statistics not counted, as
        the JAX package's ``count_params``), logged in the JAX package's line."""
        self._need_graph("info")
        n = count_params(self.model)
        LOGGER.info(f"{self.model_path}: {len(self.spec.layers)} layers, {n:,} parameters")
        return {"layers": len(self.spec.layers), "parameters": n}

    @property
    def names(self) -> Dict[int, str]:
        if self.spec is None:
            return dict(enumerate(self.artifact_meta.get("names") or []))
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
        <stem>_<i>.jpg`` (``runs/detect/predict`` by default; not with ``stream=True``); ``save`` the
        drawings (``Results.plot`` through OpenCV, with ``show_labels``, ``show_conf``, ``show_boxes`` and
        ``line_width``) as ``<project>/<name>/<stem>.jpg``, or one ``<stem>.mp4`` per video (``save_frames``:
        each frame's JPEG too); ``show`` shows them in an OpenCV window. ``embed`` is accepted and changes
        nothing, as in the JAX facade: ``embed()`` gives the vectors.
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
        if self._artifact:
            return self._predict_artifact(source, stream, kwargs)
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
        return self._outputs(list(gen), kwargs)

    def _outputs(self, results, kwargs):
        """predict's files and window (``save``, ``save_txt``, ``save_crop``, ``show``); returns ``results``."""
        out_dir = Path(kwargs.get("project") or "runs/detect") / (kwargs.get("name") or "predict")
        if kwargs.get("save"):
            self._save_results(results, out_dir, kwargs)
        if kwargs.get("save_txt") or kwargs.get("save_crop"):
            for i, r in enumerate(results):
                stem = result_stem(r.path, i)
                if kwargs.get("save_txt"):
                    r.save_txt(out_dir / "labels" / f"{stem}.txt", save_conf=bool(kwargs.get("save_conf", False)))
                if kwargs.get("save_crop"):
                    r.save_crop(out_dir / "crops", file_name=stem)
        if kwargs.get("show"):
            self._show_results(results, kwargs)
        return results

    def _predict_artifact(self, source, stream: bool, kwargs):
        """``predict`` of a Detect-family artifact through ``AutoBackend`` at its static imgsz and batch
        (``engine/backend.py artifact_predictor``); options the artifact cannot honour raise."""
        from bsyolo_tpu_torch.engine.backend import artifact_predictor

        for k in ("augment", "half", "retina_masks"):
            if kwargs.get(k):
                raise ValueError(f"predict({k}=True) needs the live graph; {self._artifact} is an exported artifact")
        conf = kwargs.get("conf")
        self.predictor = predictor = artifact_predictor(
            self.backend(), conf=0.25 if conf is None else conf, iou=kwargs.get("iou", 0.7),
            max_det=kwargs.get("max_det", 300), classes=kwargs.get("classes"),
            agnostic_nms=kwargs.get("agnostic_nms", False), stream_buffer=bool(kwargs.get("stream_buffer", False)))
        gen = predictor.stream(source, vid_stride=int(kwargs.get("vid_stride") or 1), verbose=kwargs.get("verbose", False))
        if stream:
            return gen
        return self._outputs(list(gen), kwargs)

    @staticmethod
    def _plot_options(kwargs) -> dict:
        """``Results.plot``'s options from predict's ``show_labels``, ``show_conf``, ``show_boxes`` and
        ``line_width``."""
        plot_kw = {"labels": bool(kwargs.get("show_labels", True)), "conf": bool(kwargs.get("show_conf", True)),
                   "boxes": bool(kwargs.get("show_boxes", True))}
        if kwargs.get("line_width"):
            plot_kw["line_width"] = int(kwargs["line_width"])
        return plot_kw

    def _save_results(self, results, out_dir: Path, kwargs) -> None:
        """``save=True`` (the JAX facade's layout): each image's drawing as ``<out_dir>/<stem>.jpg``; the
        frames of a video source drawn into one ``mp4v`` ``<out_dir>/<stem>.mp4`` at the source's frame
        rate, and with ``save_frames`` each also as ``<stem>_<n>.jpg``. Where OpenCV cannot open the
        video writer it raises, naming the codec (the JAX package writes nothing and says nothing)."""
        plot_kw = self._plot_options(kwargs)
        save_frames = bool(kwargs.get("save_frames", False))
        writers = {}
        try:
            for i, r in enumerate(results):
                if "#frame" not in str(r.path):
                    r.save(out_dir / f"{result_stem(r.path, i)}.jpg", **plot_kw)
                    continue
                src, _, n = str(r.path).partition("#frame")
                w = writers.get(src)
                if w is None:
                    cv2 = import_cv2("predict(save=True) of a video", CV2_VIDEO)
                    cap = cv2.VideoCapture(src)
                    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
                    cap.release()
                    out_dir.mkdir(parents=True, exist_ok=True)
                    h0, w0 = r.orig_img.shape[:2]
                    path = out_dir / f"{Path(src).stem}.mp4"
                    w = writers[src] = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), max(fps, 1.0),
                                                       (w0, h0))
                    if not w.isOpened():
                        raise RuntimeError(f"predict(save=True): OpenCV's VideoWriter could not open {path} with the "
                                           f"mp4v codec ({w0}x{h0} at {max(fps, 1.0)} fps)")
                w.write(r.plot(**plot_kw))
                if save_frames:
                    r.save(out_dir / f"{Path(src).stem}_{n}.jpg", **plot_kw)
        finally:
            for w in writers.values():
                w.release()

    def _show_results(self, results, kwargs) -> None:
        """``show=True`` (the JAX facade's): each result's drawing in the window ``bsyolo`` through
        ``cv2.imshow`` and ``waitKey(1)``; where there is no display (no ``DISPLAY`` outside Windows and
        macOS), one warning and nothing shown."""
        if not (os.environ.get("DISPLAY") or os.name == "nt" or sys.platform == "darwin"):
            LOGGER.warning("show=True: no display available, skipping imshow")
            return
        cv2 = import_cv2("predict(show=True)", CV2_DRAWING)
        plot_kw = self._plot_options(kwargs)
        for r in results:
            cv2.imshow("bsyolo", r.plot(**plot_kw))
            cv2.waitKey(1)

    def embed(self, source, stream: bool = False, embed=None, imgsz: Optional[int] = None):
        """One 1-D float32 vector per image of ``source`` (sources as ``predict``): the global-average
        pooled outputs of the ``embed`` layers, concatenated (the second-to-last layer by default),
        of the image letterboxed on the host (``letterbox_image``, as the JAX package's embed) and run
        on this model's device. A list, or a generator with ``stream=True``."""
        self._need_graph("embed")
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
        default). A YOLO-World graph trains against the text of the data's class names. Returns the
        last validation's metrics."""
        self._need_graph("train")
        overrides = dict(kwargs)
        overrides.setdefault("model", self.model_path)
        overrides.setdefault("device", str(self._device))
        self.trainer = trainer = self._trainer(overrides)
        self.metrics = trainer.train()
        self.txt_feats = getattr(trainer, "txt_feats", None)
        # a copy of the trained graph with the EMA weights and the live BatchNorm statistics; the
        # trainer's state keeps its own parameters
        self.spec, self.model, self._device = trainer.spec, copy.deepcopy(trainer.model).eval(), trainer.device
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(trainer.state.ema_params[name])
        self._img_size = trainer.args.imgsz
        return self.metrics

    def _trainer(self, overrides: Dict):
        """The trainer that ``train`` runs."""
        from bsyolo_tpu_torch.engine.classify import ClassificationTrainer
        from bsyolo_tpu_torch.engine.trainer import DetectionTrainer

        trainer_cls = ClassificationTrainer if self.task == "classify" else DetectionTrainer
        return trainer_cls(overrides=overrides, callbacks=self._callbacks)

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
        if self._artifact:  # artifact val (reference `yolo val model=best.onnx`)
            from bsyolo_tpu_torch.engine.backend import validate_artifact

            vkw = {k: kwargs[k] for k in ("conf", "iou", "max_det", "split", "max_gt") if kwargs.get(k) is not None}
            self.metrics = validate_artifact(self._artifact, data, batch=batch, imgsz=imgsz, backend=self.backend(),
                                             verbose=bool(kwargs.get("verbose", True)), **vkw)
            return self.metrics
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
        self._need_graph("save")
        from bsyolo_tpu_torch.engine.train_step import init_train_state

        meta = {"args": {"model": self.model_path if Path(self.model_path).suffix == ".yaml" else
                         (self.ckpt_meta or {}).get("args", {}).get("model", "yolo11n.yaml")},
                "epoch": -1, "fitness": 0.0, "names": [str(n) for n in self.spec.names], "task": self.task,
                "kpt_shape": list(self.spec.kpt_shape), "graph_nc": self.model.spec.nc}
        extras = None if self.txt_feats is None else {"txt_feats": np.asarray(self.txt_feats, np.float32)}
        save_checkpoint(path, init_train_state(self.model), jax_paths(self.model), meta, extras=extras)
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

    def export(self, format: str = "pt2", imgsz: Optional[int] = None, batch: int = 1, nms: bool = False,
               output: Optional[str] = None) -> str:
        """Write this graph as an artifact (``engine/exporter.py``): ``pt2``, ``pt2-int8``, ``onnx`` or ``params``
        (a ``.ckpt``), at a static (batch, imgsz); ``nms=True`` bakes NMS into a Detect graph's artifact.
        Returns the artifact's path; ``YOLO(path)`` predicts and validates with it."""
        from bsyolo_tpu_torch.engine.exporter import export_model

        self._need_graph("export")
        return export_model(self, format=format, imgsz=imgsz, batch=batch, nms=nms, output=output)


class RTDETR(YOLO):
    """The RT-DETR facade: a detection transformer (HGNetv2 or ResNet backbone, AIFI encoder, a deformable
    decoder of 300 queries), NMS-free end to end. ``train`` runs the Hungarian-matched DETR loss with
    denoising queries (``losses/detr.py``); ``predict`` and ``val`` take the decoder's top queries.

        m = RTDETR("rtdetr-l.yaml")
        m.train(data="coco8.yaml", epochs=10)
        m.predict(frames)
    """

    def __init__(self, model: Union[str, Path] = "rtdetr-l.yaml", task: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        super().__init__(model, task or "detect", device=device, seed=seed)


class YOLOWorld(YOLO):
    """The open-vocabulary YOLO-World facade: the classes are rows of text embeddings, not a fixed head.

        m = YOLOWorld("yolov8s-world.yaml")
        m.set_classes(["person", "bus"], embeddings=E)   # E: (2, 512); without it, hashed n-gram text
        results = m.predict(frames)

    CLIP is not bundled: pass CLIP ViT-B/32 embeddings (an array, a ``{name: vector}`` dict or a saved
    ``.npz`` table), or take the deterministic hashed n-gram vectors of ``utils/text_embed.py``, which drive
    the whole path but carry no visual meaning. Without ``set_classes`` the graph reads its placeholder text,
    as the JAX package's does. The text is the graph's ``txt_feats`` buffer (``nn.model.bind_text``), so
    predict, val, ``half`` and int8 all see it; ``save`` writes it into the checkpoint.
    """

    def __init__(self, model: Union[str, Path] = "yolov8s-world.yaml", task: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        super().__init__(model, task or "detect", device=device, seed=seed)

    _text_embeddings = None  # train()'s text source, for _trainer

    def train(self, text_embeddings=None, **kwargs):
        """``YOLO.train`` against the text of the data's class names: ``text_embeddings`` a (K, 512) array or
        list, a ``{name: vector}`` dict or a ``.npz`` table (looked up, "/" synonyms averaged), else the hashed
        n-gram vectors of each name's "/" synonyms, averaged (``utils/text_embed.py world_text``)."""
        self._text_embeddings = text_embeddings
        return super().train(**kwargs)

    def _trainer(self, overrides: Dict):
        from bsyolo_tpu_torch.engine.trainer import DetectionTrainer

        return DetectionTrainer(overrides=overrides, callbacks=self._callbacks, text_embeddings=self._text_embeddings)

    def set_classes(self, names, embeddings=None) -> None:
        """Bind the classes ``names`` to text rows: ``embeddings`` a (K, E) array, list or tensor, a
        ``{name: vector}`` dict or a ``.npz`` table (names looked up, "/" synonyms averaged), else the hashed
        n-gram vectors of the whole names, with a warning (``utils/text_embed.py world_text``). Rows are
        L2-normalized; the names and class count follow, and the next predict reads the new text."""
        names = [str(n) for n in names]
        self.txt_feats = world_text(names, embeddings, synonyms=False)
        bind_text(self.model, self.txt_feats)
        self.spec = dataclasses.replace(self.spec, nc=len(names), names=tuple(names))
        self.predictor = None
