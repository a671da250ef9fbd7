"""AutoBackend: one forward over every deployable artifact of the port (counterpart of
``bsyolo_tpu/engine/backend.py``).

- ``*.pt2`` and ``*.pt2-int8``: ``torch.export`` programs (``engine/exporter.py``), loaded with
  ``torch.export.load`` on ``cuda:0`` unless ``device`` names another; the port's operators are registered
  first, so the artifact's decode and int8 products launch the hand-written kernels on the card;
- ``*.onnx``: the port's numpy runtime (``onnx/runtime.py``) on the host, as the JAX package runs ONNX:
  that is the format's reference runtime here, not a fallback;
- ``*.ckpt`` and ``*.yaml``: the live graph (``YOLO``) with the JAX backend's decode.

Every kind takes ``(B, H, W, 3)`` float32 NHWC RGB in [0, 1] (numpy or a tensor) and returns the artifact's
outputs as tensors (on the backend's device; on the host for ONNX): one tensor, or a tuple where the
artifact has several. Any other suffix raises ``ValueError``. ``validate_artifact`` is artifact ``val``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from bsyolo_tpu_torch import select_device


def artifact_kind(path) -> Optional[str]:
    """``pt2``, ``onnx``, ``ckpt`` or ``yaml`` by the file's name; None for anything else."""
    p = Path(str(path))
    if p.suffix in (".pt2", ".pt2-int8") or p.name.endswith(".pt2-int8"):
        return "pt2"
    return {".onnx": "onnx", ".ckpt": "ckpt", ".yaml": "yaml", ".yml": "yaml"}.get(p.suffix)


class AutoBackend:
    def __init__(self, weights, imgsz: int = 640, device=None):
        self.path = str(weights)
        self.imgsz = imgsz
        self.kind = artifact_kind(self.path)
        if self.kind is None:
            hint = " (a JAX package artifact: load it with bsyolo_tpu)" if self.path.endswith(
                (".stablehlo", ".stablehlo-int8", ".tflite")) else ""
            raise ValueError(f"unsupported artifact: {weights}{hint} (supported: .pt2, .pt2-int8, .onnx, .ckpt, "
                             ".yaml)")
        self.meta = self._load_meta(Path(self.path))
        self.device = torch.device("cpu") if self.kind == "onnx" else select_device(device)
        getattr(self, f"_init_{self.kind}")()

    @staticmethod
    def _load_meta(p: Path) -> dict:
        """The exporter's sidecar (names, nc, imgsz, batch, nms, task), where there is one."""
        cand = Path(str(p) + ".json")
        if cand.exists():
            try:
                return json.loads(cand.read_text())
            except (OSError, ValueError):
                return {}
        return {}

    # --- loaders ---------------------------------------------------------------------------
    def _init_pt2(self):
        import bsyolo_tpu_torch.kernels  # noqa: F401 - registers the bsyolo:: operators the program calls

        with open(self.path, "rb") as f:  # a file object: torch.export names its archives .pt2 only
            ep = torch.export.load(f)
        devices = {t.device for t in ep.state_dict.values()} | {t.device for t in ep.constants.values()
                                                                if isinstance(t, torch.Tensor)}
        if devices != {self.device}:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, self.device)
        self.program = ep
        module = ep.module()
        self._fn = lambda x: module(x)

    def _init_onnx(self):
        from bsyolo_tpu_torch.onnx import OnnxModule

        module = OnnxModule(self.path)

        def run(x):
            outs = [torch.from_numpy(np.asarray(o)) for o in module(x.numpy())]
            return outs[0] if len(outs) == 1 else tuple(outs)

        self._fn = run

    def _init_ckpt(self):
        self._init_model()

    _init_yaml = _init_ckpt

    def _init_model(self):
        from bsyolo_tpu_torch.model import YOLO
        from bsyolo_tpu_torch.nn.heads import decode_detections

        y = YOLO(self.path, device=self.device)
        spec = y.spec

        def run(x):
            out = y.model(x.permute(0, 3, 1, 2).contiguous())
            if isinstance(out, dict):
                if "feats" in out:  # Segment head: boxes and coefficient maps
                    out = out["feats"]
                elif "one2one" in out:  # v10 NMS-free head
                    out = out["one2one"]
                else:
                    raise TypeError(f"AutoBackend detection decode does not support this head output ({sorted(out)}); "
                                    "use the task facade instead")
            return decode_detections(out, spec.head_strides, spec.nc, spec.reg_max)

        self._fn = run

    # --- uniform surface ---------------------------------------------------------------------
    def forward(self, im):
        """(B, H, W, 3) float32 [0, 1] -> the artifact's outputs ((B, A, 4 + nc) raw predictions for a
        decode-only Detect artifact, (B, max_det, 6) rows for an end-to-end one)."""
        x = torch.as_tensor(np.asarray(im, np.float32) if not torch.is_tensor(im) else im, dtype=torch.float32)
        with torch.inference_mode():
            return self._fn(x.to(self.device))

    __call__ = forward

    def warmup(self, batch: int = 1) -> "AutoBackend":
        self.forward(np.zeros((batch, self.imgsz, self.imgsz, 3), np.float32))
        return self


def artifact_contract(backend: AutoBackend, batch: int, imgsz: int, fallback_names=None):
    """An artifact's output contract: (e2e, nc, names). End-to-end artifacts (``nms=True``, v10, RT-DETR)
    emit (B, max_det, 6) xyxy, conf, cls rows; decode-only ones (B, A, 4 + nc), which need NMS here. The
    exporter's sidecar decides where there is one; otherwise a probe's shape does (a width of 6 is read as
    end to end, as the JAX package does)."""
    meta = backend.meta
    out_desc = meta.get("output", "")
    if meta.get("nms") or "xyxy" in out_desc:
        e2e = True
    elif out_desc:
        e2e = False
    else:
        probe = backend.forward(np.zeros((batch, imgsz, imgsz, 3), np.float32))
        probe = probe[0] if isinstance(probe, (list, tuple)) else probe
        e2e = probe.shape[-1] == 6
        meta = {**meta, "nc": meta.get("nc") or (0 if e2e else int(probe.shape[-1]) - 4)}
    nc = int(meta.get("nc") or 0)
    names_meta = meta.get("names") or fallback_names
    if isinstance(names_meta, dict):
        names = {int(k): v for k, v in names_meta.items()}
    elif names_meta:
        names = {i: n for i, n in enumerate(names_meta)}
    else:
        names = {i: str(i) for i in range(max(nc, 1))}
    nc = nc or len(names)
    return e2e, nc, names


def validate_artifact(weights, data: str, batch: int = 16, imgsz: Optional[int] = None, conf: float = 0.001,
                      iou: float = 0.7, max_det: int = 300, split: str = "val", verbose: bool = True,
                      backend: Optional[AutoBackend] = None, device=None, **kwargs):
    """mAP of an exported artifact on ``data``'s ``split`` (``YOLO("best.onnx").val()``), as the JAX
    package's ``validate_artifact``: Detect-family artifacts only (checked against the sidecar's task), at
    the artifact's own static imgsz and batch; a decode-only artifact's rows go through NMS here at
    ``conf`` and ``iou``, an end-to-end artifact's rows are taken as they are. ``backend`` reuses a loaded
    artifact."""
    from types import SimpleNamespace

    from bsyolo_tpu_torch.data import DataLoader, YOLODataset, load_dataset_yaml
    from bsyolo_tpu_torch.engine.trainer import val_batches
    from bsyolo_tpu_torch.engine.validator import DetectionValidator
    from bsyolo_tpu_torch.ops.nms import non_max_suppression
    from bsyolo_tpu_torch.utils import LOGGER

    backend = backend or AutoBackend(weights, imgsz or 640, device=device)
    meta = backend.meta
    task = meta.get("task")
    if task is not None and task != "detect":
        raise ValueError(f"artifact validation supports detect-family artifacts; this one was exported from a "
                         f"'{task}' model (its output layout needs the {task} validator — rebuild from the "
                         ".yaml/.ckpt to val it)")
    art_imgsz = int(meta.get("imgsz", 0) or 0)
    if art_imgsz and imgsz and imgsz != art_imgsz:
        LOGGER.info(f"artifact was exported at imgsz={art_imgsz} (static shapes); validating at that size instead "
                    f"of imgsz={imgsz}")
    imgsz = art_imgsz or imgsz or 640
    backend.imgsz = imgsz
    art_batch = int(meta.get("batch", 1))
    if batch != art_batch:
        LOGGER.info(f"artifact was exported with batch={art_batch} (static shapes); validating at that batch "
                    f"instead of batch={batch}")
        batch = art_batch
    d = load_dataset_yaml(data)
    if not d.get(split):
        raise KeyError(f"dataset {data} has no '{split}' split")
    ds = YOLODataset(d[split], imgsz=imgsz, augment=False, max_gt=kwargs.get("max_gt", 128))
    loader = DataLoader(ds, batch, shuffle=False, drop_last=False)
    e2e, nc, names = artifact_contract(backend, batch, imgsz, fallback_names=d.get("names"))
    spec = SimpleNamespace(task="detect", nc=nc, names=tuple(names.values()), head_strides=(8, 16, 32), reg_max=16)

    @torch.inference_mode()
    def forward_fn(variables, img):
        x = torch.as_tensor(img).to(backend.device).permute(0, 2, 3, 1).float() / 255.0  # NCHW uint8 -> NHWC
        if x.shape[0] < batch:  # the last batch, padded to the artifact's static batch
            x = torch.cat([x, x.new_zeros((batch - x.shape[0], *x.shape[1:]))])
        preds = backend.forward(x)
        preds = (preds[0] if isinstance(preds, (list, tuple)) else preds)[: img.shape[0]]
        if e2e:
            return preds
        return non_max_suppression(preds, conf_thres=conf, iou_thres=iou, max_det=max_det, nc=nc)

    validator = DetectionValidator(model=None, spec=spec, conf=conf, iou=iou, max_det=max_det, names=names,
                                   forward_fn=forward_fn, device=backend.device)
    return validator(None, val_batches(loader, backend.device), verbose=verbose, im_files=ds.img_files)


def artifact_predictor(backend: AutoBackend, conf: float = 0.25, iou: float = 0.7, max_det: int = 300,
                       classes=None, agnostic_nms: bool = False, stream_buffer: bool = False):
    """A ``DetectionPredictor`` that runs a Detect-family artifact at its static imgsz and batch (frames
    letterboxed on the backend's device and padded to the batch, as the live predictor does): a decode-only
    artifact's rows through NMS here, an end-to-end artifact's rows above ``conf``."""
    from types import SimpleNamespace

    from bsyolo_tpu_torch.engine.predictor import DetectionPredictor
    from bsyolo_tpu_torch.ops.nms import non_max_suppression

    task = backend.meta.get("task")
    if task is not None and task != "detect":
        raise ValueError(f"artifact predict supports detect-family artifacts; this one was exported from a '{task}' "
                         "model (rebuild from the .yaml/.ckpt to predict with it)")
    imgsz, batch = int(backend.meta.get("imgsz") or backend.imgsz), int(backend.meta.get("batch", 1))
    e2e, nc, names = artifact_contract(backend, batch, imgsz)
    spec = SimpleNamespace(task="detect", nc=nc, names=tuple(names.values()), head=SimpleNamespace(module="Detect"),
                           head_strides=(8, 16, 32), reg_max=16)

    class ArtifactPredictor(DetectionPredictor):
        @torch.inference_mode()
        def forward(self, x: torch.Tensor):
            preds = backend.forward(x.float().permute(0, 2, 3, 1) / 255.0)
            preds = preds[0] if isinstance(preds, (list, tuple)) else preds
            if e2e:
                ok = preds[..., 4:5] > self.conf
                return torch.cat([preds[..., :5] * ok, torch.where(ok, preds[..., 5:], -1.0)], -1)
            return non_max_suppression(preds, conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det, nc=nc,
                                       agnostic=self.agnostic_nms)

    return ArtifactPredictor(None, spec, backend.device, conf=conf, iou=iou, max_det=max_det, imgsz=imgsz,
                             classes=classes, agnostic_nms=agnostic_nms, names=names, batch=batch,
                             stream_buffer=stream_buffer)
