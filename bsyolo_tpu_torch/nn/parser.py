"""Graph-config parser (counterpart of ``bsyolo_tpu/nn/parser.py``).

Turns a model YAML (backbone/head rows of ``[from, repeats, module, args]``
with ``scales:`` compound scaling, or ``depth_multiple``/``width_multiple``)
into a static ``ModelSpec``: channel arithmetic, depth/width scaling, stride
propagation and the graph-wide ``activation:`` happen here. The modules of the
BS-YOLO graphs (``cfg/models/11``), of the YOLO v3, v5, v6, v8, v9 and v10
graphs (``cfg/models/v3`` to ``v10``) and of the RT-DETR graphs
(``cfg/models/rt-detr``, ``v8/yolov8-rtdetr.yaml``), of the YOLO-World graphs
(``v8/yolov8-world.yaml``, ``v8/yolov8-worldv2.yaml``) and of the YOLO-NAS graphs
(``cfg/models/nas``) are accepted, with the Detect, Segment, Pose, OBB, Classify,
v10Detect, RTDETRDecoder, WorldDetect and NASDetect heads; a head on a graph
without C3k2 is ``legacy`` (its class branch two 3x3 convs). Any other module
raises ``NotImplementedError`` naming it: SAM, SAM2 and FastSAM are not YAML
graphs (ROADMAP item 13.4).
"""

from __future__ import annotations

import ast
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Tuple

from bsyolo_tpu_torch.cfg import read_yaml

# modules that follow the conv-like channel rule c2 = make_divisible(min(c2, max_ch) * width, 8)
_CONVLIKE = {"Conv", "DWConv", "Bottleneck", "SPP", "SPPF", "C2PSA", "PSA", "C2", "C2f", "C2fCIB", "C3", "C3k2",
             "C3k2_gai", "SCDown", "GhostConv", "GhostBottleneck", "C3Ghost", "RepNCSPELAN4", "ELAN1", "AConv",
             "ADown", "SPPELAN", "ConvTranspose2d", "RepC3"}
# modules that take the (depth-scaled) repeat count as args[1]
_REPEAT = {"C2", "C2f", "C2fCIB", "C3", "C3k2", "C3k2_gai", "C2PSA", "C3Ghost", "RepC3"}
# the heads the port builds -> the task they serve
HEAD_TASKS = {"Detect": "detect", "Segment": "segment", "Pose": "pose", "OBB": "obb", "Classify": "classify",
              "v10Detect": "detect", "RTDETRDecoder": "detect", "WorldDetect": "detect", "NASDetect": "detect"}
# the heads on a detection trunk of several levels (every head but Classify)
_LEVEL_HEADS = {"Detect", "Segment", "Pose", "OBB", "v10Detect"}
# the modules that read the graph's text (YOLO-World)
TEXT_MODULES = ("C2fAttn", "ImagePoolingAttn", "WorldDetect")


def activation_name(text) -> str:
    """The activation a YAML's ``activation:`` value names (``nn.ReLU()`` -> ``relu``), as the JAX
    parser reads it: SiLU unless another known name appears in the text."""
    text = str(text or "").lower()
    for key, name in (("leakyrelu", "lrelu"), ("relu", "relu"), ("silu", "silu"), ("gelu", "gelu"),
                      ("hardswish", "hardswish"), ("mish", "mish")):
        if key in text:
            return name
    return "silu"


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channels up to the nearest multiple of ``divisor``."""
    return math.ceil(x / divisor) * divisor


@dataclass(frozen=True)
class LayerSpec:
    i: int  # layer index
    f: Tuple[int, ...]  # from indices (absolute; -1 means the previous layer)
    n: int  # repeats left after CSP modules absorbed theirs
    module: str  # module name, e.g. "Conv", "C3k2_gai"
    args: Tuple[Any, ...]  # resolved module args (without c1)
    c1: int  # input channels
    c2: int  # output channels
    stride: int  # cumulative downsample factor of this layer's output


@dataclass(frozen=True)
class ModelSpec:
    layers: Tuple[LayerSpec, ...]
    save: Tuple[int, ...]  # layer indices whose outputs are reused later
    nc: int
    scale: str
    names: Tuple[str, ...] = ()
    task: str = "detect"  # from the head: detect, segment, pose, obb or classify
    kpt_shape: Tuple[int, int] = (17, 3)  # (keypoints, dims) of a Pose head
    dropout: float = 0.0  # the Classify head's dropout rate in train mode (the cfg's ``dropout``)
    act: str = "silu"  # every Conv's activation (the YAML's ``activation:``; ``nn.modules.ACTIVATIONS``)

    @property
    def head(self) -> LayerSpec:
        return self.layers[-1]

    @property
    def head_strides(self) -> Tuple[int, ...]:
        return tuple(self.layers[j].stride for j in self.head.f)

    @property
    def reg_max(self) -> int:
        """DFL bins of the head: NASDetect's 17 (YOLO-NAS counts 16 bin edges), every other head's 16."""
        return 17 if self.head.module == "NASDetect" else 16

    @property
    def world(self) -> bool:
        """Whether the graph reads text (C2fAttn, ImagePoolingAttn, WorldDetect): a YOLO-World graph."""
        return any(layer.module in TEXT_MODULES for layer in self.layers)


def load_model_yaml(path) -> dict:
    """Read a model YAML; ``yolo11n.yaml`` reads ``yolo11.yaml`` at scale ``n``."""
    path = Path(path)
    unified, scale = path, ""
    if not path.exists():
        m = re.match(r"(.*yolov?\d+)([nslmx])(.*)$", path.stem)
        if m:
            scale = m.group(2)
            unified = path.with_name(m.group(1) + m.group(3) + path.suffix)
    d = read_yaml(unified)
    if scale:
        d["scale"] = scale
    return d


def _literal(a: Any, names: dict) -> Any:
    if isinstance(a, str):
        if a in names:
            return names[a]
        try:
            return ast.literal_eval(a)
        except (ValueError, SyntaxError):
            return a
    return a


def _freeze(a: Any) -> Any:
    return tuple(_freeze(x) for x in a) if isinstance(a, list) else a


def parse_model_yaml(d: dict, ch: int = 3, scale: str = "") -> ModelSpec:
    """Parse a model dict into a ModelSpec (the reference ``parse_model`` rules)."""
    nc = int(d.get("nc", 80))
    act = activation_name(d.get("activation"))
    scales = d.get("scales")
    depth, width, max_channels = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")
    scale = scale or d.get("scale", "")
    if scales:
        scale = scale or next(iter(scales))
        depth, width, max_channels = scales[scale]

    kpt_shape = tuple(d.get("kpt_shape", (17, 3)))
    legacy = True
    channels, strides = [ch], [1]
    layers, save = [], set()
    names = {"nc": nc, "kpt_shape": list(kpt_shape)}
    task = "detect"
    for i, (f, n, m, args) in enumerate(list(d["backbone"]) + list(d["head"])):
        m = m.replace("nn.", "")
        args = [_literal(a, names) for a in args]
        n_rep = max(round(n * depth), 1) if n > 1 else n
        fl = [f] if isinstance(f, int) else list(f)
        fl = [x if x == -1 else x % i for x in fl]
        c1 = channels[fl[0]] if fl[0] != -1 else channels[-1]
        in_stride = strides[fl[0]] if fl[0] != -1 else strides[-1]
        out_stride = in_stride

        if m in _CONVLIKE:
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c2, *args[1:]]
            if m in _REPEAT:
                args.insert(1, n_rep)
                n_rep = 1
            if m in ("C3k2", "C3k2_gai"):
                legacy = False
                if scale in "mlx" and len(args) >= 3:
                    args[2] = True  # c3k=True at m/l/x
            if m in ("Conv", "DWConv", "SCDown", "GhostConv") and len(args) >= 3:
                out_stride = in_stride * args[2]
            elif m in ("AConv", "ADown"):
                out_stride = in_stride * 2
            elif m == "ConvTranspose2d":  # (c2, k, s, p): a stride-s upsample
                out_stride = in_stride // (args[2] if len(args) > 2 else 2)
        elif m in ("MSCAAttention", "ELA"):
            c2 = c1
            args = [c1]
        elif m in ("Identity", "ZeroPad2d"):
            c2 = c1
        elif m == "CBLinear":  # ([c2s], k, s): the taps' widths, unscaled
            c2 = sum(args[0])
        elif m == "CBFuse":  # the last input's width and stride
            c2 = channels[fl[-1]]
            out_stride = strides[fl[-1]]
        elif m == "ResNetLayer":  # (c1, c2, s, is_first, n): the stem downsamples 4x, a stage s
            is_first = args[3] if len(args) > 3 else False
            c2 = args[1] if is_first else 4 * args[1]
            out_stride = in_stride * (4 if is_first else (args[2] if len(args) > 2 else 1))
        elif m == "HGStem":  # (cm, c2), unscaled; the stem downsamples 4x
            c2 = args[1]
            out_stride = in_stride * 4
        elif m == "HGBlock":  # (cm, c2, k, light, shortcut) -> (cm, c2, k, n, light, shortcut)
            c2 = args[1]
            args = [args[0], args[1], args[2] if len(args) > 2 else 3, n_rep, *args[3:]]
            n_rep = 1
        elif m == "AIFI":  # (cm, num_heads)
            c2 = c1
        elif m == "RTDETRDecoder":  # (nc, in_ch, ...)
            args = [args[0], tuple(channels[x] for x in fl), *args[1:]]
            task = "detect"
            c2 = 0
            out_stride = 0
        elif m == "SpaceToDepth":
            b = args[0] if args else 2
            c2 = c1 * b * b
            out_stride = in_stride * b
        elif m == "MaxPool2d":  # (k, s, p)
            c2 = c1
            out_stride = in_stride * (args[1] if len(args) > 1 else args[0])
        elif m == "Upsample":
            c2 = c1
            out_stride = in_stride // int(args[1] if len(args) > 1 else 2)
        elif m == "Concat":
            c2 = sum(channels[x] if x != -1 else channels[-1] for x in fl)
        elif m == "Classify":
            c2 = args[0]
            args = [c2]
            task = "classify"
        elif m in _LEVEL_HEADS:
            if m == "Segment":  # [nc, nm, npr]: the prototype width is width-scaled
                args = [args[0], args[1], make_divisible(min(args[2], max_channels) * width, 8)]
            elif m == "Pose":
                kpt_shape = tuple(args[1])
                args = [args[0], kpt_shape]
            elif m == "OBB":  # [nc, ne]: ne angle channels per anchor
                args = [args[0], int(args[1]) if len(args) > 1 else 1]
            args = [*args, tuple(channels[x] for x in fl), legacy]  # v10Detect ignores legacy, as in JAX
            task = HEAD_TASKS[m]
            c2 = 0
            out_stride = 0
        elif m == "C2fAttn":  # (c2, ec, nh) -> (c2, n, ec, nh); ec and nh scale with the width
            c2 = make_divisible(min(args[0], max_channels) * width, 8)
            ec = make_divisible(min(args[1], max_channels // 2) * width, 8)
            nh = int(max(round(min(args[2], max_channels // 2 // 32)) * width, 1)) if args[2] > 1 else args[2]
            args = [c2, n_rep, ec, nh]
            n_rep = 1
        elif m == "ImagePoolingAttn":  # (ec, in_ch); its output is the text, so the width stays c1
            args = [args[0] if args else 256, tuple(channels[x] for x in fl)]
            c2 = c1
        elif m == "WorldDetect":  # (nc, embed, with_bn, in_ch, legacy)
            args = [*args, tuple(channels[x] for x in fl), legacy]
            task = "detect"
            c2 = 0
            out_stride = 0
        elif m == "Index":
            c2 = channels[fl[-1]]
        elif m in ("YoloNASStem", "YoloNASStage", "NASDown"):  # (c2, n, hidden[, concat]): unscaled widths
            c2 = args[0]
            out_stride = in_stride * 2
        elif m == "NASUpMerge":  # inputs (pre, skip1, skip2); the output at skip1's stride
            c2 = args[0]
            out_stride = in_stride // 2
        elif m == "NASDetect":  # (nc, inter widths, in_ch)
            args = [args[0] if args else nc, *args[1:], tuple(channels[x] for x in fl)]
            task = "detect"
            c2 = 0
            out_stride = 0
        else:
            raise NotImplementedError(f"module '{m}' (layer {i}) is not supported by the port's graph parser")

        layers.append(LayerSpec(i, tuple(fl), n_rep, m, tuple(_freeze(a) for a in args), c1, c2, out_stride))
        save.update(x % i for x in fl if x != -1)
        if i == 0:
            channels, strides = [], []
        channels.append(c2)
        strides.append(out_stride)

    if layers[-1].module not in HEAD_TASKS:
        raise NotImplementedError(f"graph head {layers[-1].module!r}: the port serves Detect, Segment, Pose, OBB, "
                                  "Classify, v10Detect, RTDETRDecoder, WorldDetect and NASDetect graphs only")
    names_map = d.get("names") or {}
    class_names = tuple(names_map[k] for k in sorted(names_map)) if names_map else tuple(str(j) for j in range(nc))
    return ModelSpec(
        layers=tuple(layers),
        save=tuple(sorted(save)),
        nc=nc,
        scale=scale,
        names=class_names,
        task=task,
        kpt_shape=kpt_shape,
        act=act,
    )
