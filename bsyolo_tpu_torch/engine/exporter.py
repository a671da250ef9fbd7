"""Model export (counterpart of ``bsyolo_tpu/engine/exporter.py``).

Every artifact embeds the whole predict path of the graph (forward and decode; NMS with ``nms=True`` on a
Detect head) at static shapes, takes ``(B, imgsz, imgsz, 3)`` float32 NHWC RGB in [0, 1] and transposes
inside, and has the JAX package's sidecar ``<artifact>.json`` (imgsz, batch, nc, names, task, nms, input,
output), so an artifact of either package serves the other's consumers. Formats:

- ``pt2``, in StableHLO's place: ``torch.export`` of the predict closure with the weights inside, saved
  with ``torch.export.save``; the kernels are the operators ``bsyolo::decode_xywh``, ``bsyolo::box_best``
  and ``bsyolo::int8_matmul`` (``kernels/``), so a loaded artifact launches them on the card
  (``engine/backend.py AutoBackend``);
- ``pt2-int8``, in ``stablehlo-int8``'s place: the same with every quantizable conv in int8, calibrated as
  the JAX exporter does (four uniform random batches, seed 0) unless the graph is already in int8 mode,
  whose mode is restored afterwards; the conv codes and scales are tensors of the graph
  (``Conv.freeze_int8_codes``);
- ``onnx``: opset 13 through the port's own writer (``onnx/lower.py``), evaluated by its numpy runtime;
- ``params``: a ``.ckpt``.

``stablehlo`` and ``stablehlo-int8`` name the JAX package's formats; the TensorFlow ones need TensorFlow,
which neither machine has. A YOLO-World graph's text is its ``txt_feats`` buffer, baked in as it stands.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from bsyolo_tpu_torch.utils import LOGGER

FORMATS = ("pt2", "pt2-int8", "onnx", "params")
_TF_FORMATS = ("saved_model", "tflite", "tflite-fp16", "tflite-int8")


class ExportPredict(nn.Module):
    """The predict closure of one task around ``graph``, as an ``nn.Module`` so that ``torch.export``
    lifts the graph's weights into the artifact: NHWC float32 in, the task's outputs out."""

    def __init__(self, graph: nn.Module, fn):
        super().__init__()
        self.net = graph  # not "graph": an exported program's module has a ``graph`` of its own
        self.fn = fn

    def forward(self, x: torch.Tensor):
        # contiguous NCHW, as the live graph reads a letterboxed batch: a permuted NHWC view would carry the
        # channels-last layout through cuDNN's convolutions into the head's levels, which the decode kernel refuses
        return self.fn(self.net, x.permute(0, 3, 1, 2).contiguous())


def build_export_predict(spec, nms: bool):
    """(fn(graph, NCHW x) -> outputs, output description) of ``spec``'s task, as the JAX exporter's
    ``_build_export_predict``: decode only, NMS left to the consumer, except the NMS-free heads (v10,
    RT-DETR) and ``nms=True`` on the plain Detect head (``(B, 300, 6)``); ``nms=True`` on any other head
    raises ``ValueError``."""
    from bsyolo_tpu_torch.nn.heads import decode_detections, decode_extras, decode_keypoints, decode_obb, postprocess_e2e
    from bsyolo_tpu_torch.nn.transformer import decode_rtdetr
    from bsyolo_tpu_torch.ops.nms import non_max_suppression

    head_module = getattr(spec.head, "module", "")
    strides, nc, reg_max = spec.head_strides, spec.nc, spec.reg_max
    if nms and (spec.task != "detect" or head_module in ("v10Detect", "RTDETRDecoder")):
        raise ValueError("nms=True export is only supported for the plain Detect head; "
                         "v10/RT-DETR are NMS-free and other tasks decode consumer-side")
    if spec.task == "classify":
        return (lambda g, x: torch.softmax(g(x).float(), -1)), "(B, nc) softmax probs"
    if spec.task == "segment":
        def segment(g, x):
            out = g(x)
            feats = out["feats"]
            preds = decode_detections(feats, strides, nc, reg_max)
            return torch.cat([preds, decode_extras(feats, nc, reg_max).float()], -1), out["proto"].permute(0, 2, 3, 1)

        return segment, "((B, anchors, 4+nc+nm) xywh+scores+coeffs, (B, h/4, w/4, nm) proto NHWC)"
    if spec.task == "pose":
        kpt_shape = tuple(spec.kpt_shape)

        def pose(g, x):
            feats = g(x)
            preds = decode_detections(feats, strides, nc, reg_max)
            kpts = decode_keypoints(decode_extras(feats, nc, reg_max), feats, strides, kpt_shape)
            return torch.cat([preds, kpts.reshape(kpts.shape[0], kpts.shape[1], -1)], -1)

        return pose, f"(B, anchors, 4+nc+{kpt_shape[0] * kpt_shape[1]}) xywh+scores+decoded kpts"
    if spec.task == "obb":
        return (lambda g, x: decode_obb(g(x), strides, nc, reg_max)), "(B, anchors, 4+nc+1) xywh+scores+angle(rad)"
    if head_module == "v10Detect":
        def v10(g, x):
            return postprocess_e2e(decode_detections(g(x)["one2one"], strides, nc, reg_max), max_det=300, nc=nc)

        return v10, "(B, 300, 6) xyxy conf cls (NMS-free e2e)"
    if head_module == "RTDETRDecoder":
        def detr(g, x):
            return decode_rtdetr(g(x), (x.shape[2], x.shape[3]), conf_thres=0.0, max_det=300)

        return detr, "(B, 300, 6) xyxy conf cls (NMS-free queries)"

    def detect(g, x):
        preds = decode_detections(g(x), strides, nc, reg_max)
        if nms:
            return non_max_suppression(preds, conf_thres=0.25, iou_thres=0.7, max_det=300)
        return preds

    return detect, "(B, 300, 6) xyxy conf cls" if nms else "(B, anchors, 4+nc) xywh+scores"


def write_meta(out, spec, imgsz: int, batch: int, nms: bool, output_desc: str, extra=None) -> Path:
    """The sidecar ``<out>.json``, the JAX exporter's ``_write_meta`` contract (``AutoBackend`` and
    ``validate_artifact`` read it): imgsz and batch pin the static shapes, task gates artifact
    validation, names feed the metrics."""
    meta = {"imgsz": imgsz, "batch": batch, "nc": spec.nc, "names": list(spec.names), "task": spec.task, "nms": nms,
            "input": "NHWC float32 [0,1] RGB", "output": output_desc}
    if extra:
        meta.update(extra)
    path = Path(str(out) + ".json")
    path.write_text(json.dumps(meta, indent=2))
    return path


def export_program(graph: nn.Module, spec, imgsz: int, batch: int = 1, nms: bool = False):
    """(``torch.export.ExportedProgram`` of ``graph``'s predict path at (batch, imgsz, imgsz, 3), output
    description), traced on the graph's device in eval mode."""
    fn, desc = build_export_predict(spec, nms)
    dev = next(graph.parameters()).device
    x = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.float32, device=dev)
    was_training = graph.training
    graph.eval()
    try:
        with torch.no_grad():
            ep = torch.export.export(ExportPredict(graph, fn), (x,), strict=False)
    finally:
        graph.train(was_training)
    return ep, desc


def _int8_graph(yolo, imgsz: int, batch: int) -> nn.Module:
    """A copy of the facade's graph in int8 mode with its conv codes held as buffers: the graph's own
    scales where its int8 mode is on, else static scales calibrated on four uniform random batches (seed
    0, as the JAX exporter's sweep); the facade's graph leaves in the mode it came in."""
    from bsyolo_tpu_torch.nn.modules import Conv, int8_inference, set_int8_inference
    from bsyolo_tpu_torch.nn.quant import calibrate_int8

    model = yolo.model
    preset = int8_inference(model)
    if not preset:
        rng = np.random.default_rng(0)
        dev = next(model.parameters()).device
        batches = [torch.from_numpy(rng.uniform(0, 1, (batch, imgsz, imgsz, 3)).astype(np.float32))
                   .permute(0, 3, 1, 2).contiguous().to(dev) for _ in range(4)]
        set_int8_inference(model, True, calibrate_int8(model, batches))
    try:
        graph = copy.deepcopy(model).eval()
    finally:
        if not preset:
            set_int8_inference(model, False)
    for m in graph.modules():
        if isinstance(m, Conv) and m.int8 and m.conv.groups == 1:
            m.freeze_int8_codes()
    return graph


def export_model(yolo, format: str = "pt2", imgsz: Optional[int] = None, batch: int = 1, nms: bool = False,
                 output: Optional[str] = None) -> str:
    """Write ``yolo``'s graph as ``format`` (``FORMATS``) at a static (batch, imgsz) and return the
    artifact's path (``<model stem>.<format>`` unless ``output`` names one; ``.onnx`` and ``.ckpt`` by
    suffix)."""
    if format in ("stablehlo", "stablehlo-int8"):
        raise ValueError(f"format '{format}' is the JAX package's (bsyolo_tpu); the port's counterparts are "
                         f"'{format.replace('stablehlo', 'pt2')}' (torch.export)")
    if format in _TF_FORMATS:
        raise RuntimeError(f"format '{format}' requires tensorflow: No module named 'tensorflow'")
    if format not in FORMATS:
        raise ValueError(f"unsupported export format: {format} (available: {', '.join(FORMATS)})")
    imgsz = int(imgsz or yolo._img_size)
    spec = yolo.spec
    name = Path(yolo.model_path).stem
    out = Path(output or f"{name}.{format}")
    if format == "params":
        return str(yolo.save(str(out.with_suffix(".ckpt"))))
    t0 = time.perf_counter()
    graph = _int8_graph(yolo, imgsz, batch) if format == "pt2-int8" else yolo.model
    ep, desc = export_program(graph, spec, imgsz, batch, nms)
    extra = None
    if format == "onnx":
        from bsyolo_tpu_torch.onnx import export_onnx

        out = out.with_suffix(".onnx")
        export_onnx(ep, None, out, input_names=["images"], output_names=["output0", "output1"], name=name)
        extra = {"opset": 13}
    else:
        if format == "pt2-int8":
            extra = {"quant": "int8 convs, per-out-channel weight + static activation scales"}
        with open(out, "wb") as f:  # a file object: torch.export names its archives .pt2 only
            torch.export.save(ep, f)
    write_meta(out, spec, imgsz, batch, nms, desc, extra)
    LOGGER.info(f"exported {format} to {out} ({out.stat().st_size} bytes) in {time.perf_counter() - t0:.1f}s")
    return str(out)
