"""Graph-config parser (counterpart of ``bsyolo_tpu/nn/parser.py``).

Turns a model YAML (backbone/head rows of ``[from, repeats, module, args]``
with ``scales:`` compound scaling) into a static ``ModelSpec``: channel
arithmetic, depth/width scaling and stride propagation all happen here. Only
the modules of the BS-YOLO detection graphs (``cfg/models/11/yolo11.yaml`` and
``yolo11old.yaml``) are accepted; any other module raises
``NotImplementedError`` naming it.
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
_CONVLIKE = {"Conv", "DWConv", "Bottleneck", "SPPF", "C2PSA", "C2f", "C3", "C3k2", "C3k2_gai", "SCDown"}
# modules that take the (depth-scaled) repeat count as args[1]
_REPEAT = {"C2f", "C3", "C3k2", "C3k2_gai", "C2PSA"}


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

    @property
    def head(self) -> LayerSpec:
        return self.layers[-1]

    @property
    def head_strides(self) -> Tuple[int, ...]:
        return tuple(self.layers[j].stride for j in self.head.f)

    @property
    def reg_max(self) -> int:
        return 16


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
    if d.get("activation"):
        raise NotImplementedError(f"activation {d['activation']!r}: the port's graphs use SiLU only")
    scales = d.get("scales")
    depth, width, max_channels = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")
    scale = scale or d.get("scale", "")
    if scales:
        scale = scale or next(iter(scales))
        depth, width, max_channels = scales[scale]

    legacy = True
    channels, strides = [ch], [1]
    layers, save = [], set()
    names = {"nc": nc}
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
            if m in ("Conv", "DWConv", "SCDown") and len(args) >= 3:
                out_stride = in_stride * args[2]
        elif m in ("MSCAAttention", "ELA"):
            c2 = c1
            args = [c1]
        elif m == "Upsample":
            c2 = c1
            out_stride = in_stride // int(args[1] if len(args) > 1 else 2)
        elif m == "Concat":
            c2 = sum(channels[x] if x != -1 else channels[-1] for x in fl)
        elif m == "Detect":
            if legacy:
                raise NotImplementedError("legacy Detect (graphs without C3k2) is not ported")
            args = [*args, tuple(channels[x] for x in fl)]
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

    if layers[-1].module != "Detect":
        raise NotImplementedError(f"graph head {layers[-1].module!r}: the port serves Detect graphs only")
    names_map = d.get("names") or {}
    class_names = tuple(names_map[k] for k in sorted(names_map)) if names_map else tuple(str(j) for j in range(nc))
    return ModelSpec(
        layers=tuple(layers),
        save=tuple(sorted(save)),
        nc=nc,
        scale=scale,
        names=class_names,
    )
