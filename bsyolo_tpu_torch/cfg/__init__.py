"""Bundled graph configs and the YAML reader for them.

The machines the port serves on carry no PyYAML, so the port reads its graph
files with its own reader for the subset of YAML they use: comments, plain and
quoted scalars, ``key: value`` mappings nested by indentation, single-line flow
lists, and block lists whose items are scalars or flow lists. Scalars resolve
as PyYAML's ``safe_load`` resolves them (YAML 1.1: ``True``/``yes`` are bools,
``None`` is a string, ``1e-3`` is a string, ``0.5`` a float). Anything outside
the subset raises :class:`YamlSubsetError` rather than being read differently.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, List, Tuple

CFG_ROOT = Path(__file__).resolve().parent

_SCALE_RE = re.compile(r"(.*yolov?\d+)([nslmx])(.*)$")


class YamlSubsetError(ValueError):
    """The text uses YAML outside the subset this reader supports."""


def model_yaml_path(name: str) -> Path:
    """Resolve a model YAML by name against the bundled ``cfg/models`` tree.

    A scale-suffixed name (``yolo11n.yaml``) resolves to its unified file's
    directory but keeps its own name, so the loader reads the scale from it.
    """
    p = Path(name)
    if p.exists():
        return p
    names = [p.name]
    m = _SCALE_RE.match(p.stem)
    if m:
        names.append(m.group(1) + m.group(3) + p.suffix)
    bundled = sorted(CFG_ROOT.glob("models/**/*.yaml"))
    for cand in bundled:
        if cand.name == names[0]:
            return cand
    if len(names) > 1:
        for cand in bundled:
            if cand.name == names[1]:
                return cand.with_name(p.name)
    raise FileNotFoundError(f"no bundled graph config named {name!r} under {CFG_ROOT / 'models'}")


# --- scalars ---------------------------------------------------------------

_BOOL = {
    **{s: True for s in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{s: False for s in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT_DEC = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+$"
)
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_FLOAT_OTHER = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")


def _resolve_plain(s: str) -> Any:
    """A plain scalar as PyYAML's SafeLoader types it."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT_DEC.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    m = _INF.match(s)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(s):
        return math.nan
    if _INT_OTHER.match(s) or _FLOAT_OTHER.match(s) or _TIMESTAMP.match(s) or s in ("=", "<<"):
        raise YamlSubsetError(f"scalar {s!r}: non-decimal numbers, timestamps and merge keys are not supported")
    if s[0] in "&*!|>%@`{":
        raise YamlSubsetError(f"scalar {s!r}: anchors, aliases, tags, block scalars and flow maps are not supported")
    return s


_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """Parse a quoted scalar starting at text[i]; return (value, index after it)."""
    q = text[i]
    out: List[str] = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1 : j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = text[j + 1 : j + 2]
            if e not in _ESCAPES:
                raise YamlSubsetError(f"escape \\{e} is not supported")
            out.append(_ESCAPES[e])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise YamlSubsetError(f"unterminated quoted scalar in {text!r} (multi-line scalars are not supported)")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace, outside quotes."""
    i, quote = 0, None
    while i < len(line):
        c = line[i]
        if quote:
            if c == quote:
                if quote == "'" and line[i + 1 : i + 2] == "'":
                    i += 2
                    continue
                quote = None
            elif c == "\\" and quote == '"':
                i += 1
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[,-:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


# --- flow lists ------------------------------------------------------------


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """Parse one flow node at text[i] (list, quoted or plain scalar)."""
    while i < len(text) and text[i] == " ":
        i += 1
    if i >= len(text):
        raise YamlSubsetError(f"flow list in {text!r} does not close on its line")
    c = text[i]
    if c == "[":
        items: List[Any] = []
        i += 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i >= len(text):
                raise YamlSubsetError(f"flow list in {text!r} does not close on its line")
            if text[i] == "]":
                return items, i + 1
            item, i = _flow(text, i)
            items.append(item)
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == ",":
                i += 1
            elif i >= len(text) or text[i] != "]":
                raise YamlSubsetError(f"expected ',' or ']' at column {i} of {text!r}")
    if c == "{":
        raise YamlSubsetError(f"flow mappings are not supported: {text!r}")
    if c in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",[]{}":
        if text[j] == ":" and (j + 1 == len(text) or text[j + 1] == " "):
            raise YamlSubsetError(f"mappings inside flow lists are not supported: {text!r}")
        j += 1
    return _resolve_plain(text[i:j].strip()), j


def _value(text: str) -> Any:
    """An inline value: a flow list, a quoted scalar or a plain scalar, alone on its line."""
    text = text.strip()
    if text[:1] in ("[", "'", '"'):
        v, end = _flow(text, 0)
        if text[end:].strip():
            raise YamlSubsetError(f"trailing text after value in {text!r}")
        return v
    return _resolve_plain(text)


# --- block structure -------------------------------------------------------


def _split_key(content: str) -> Tuple[Any, str]:
    """``key: rest`` -> (resolved key, rest); raises when the line is no mapping entry."""
    if content[:1] in ("'", '"'):
        key, end = _quoted(content, 0)
        rest = content[end:]
    else:
        m = re.match(r"([^:]*?):(?: |$)", content)
        if not m:
            raise YamlSubsetError(f"expected 'key: value', got {content!r}")
        key, rest = _resolve_plain(m.group(1).strip()), content[m.end(1) :]
    if not rest.startswith(":") or not (len(rest) == 1 or rest[1] == " "):
        raise YamlSubsetError(f"expected 'key: value', got {content!r}")
    return key, rest[1:].strip()


def _block(lines: List[Tuple[int, str]], pos: int, indent: int) -> Tuple[Any, int]:
    """Parse the block node whose lines start at ``pos`` with indentation ``indent``."""
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        seq: List[Any] = []
        while pos < len(lines) and lines[pos][0] == indent and lines[pos][1][:2] in ("- ", "-"):
            item = lines[pos][1][1:].strip()
            if not item:
                raise YamlSubsetError("block list items must be a scalar or flow list on the dash's line")
            if item[:1] not in ("[", "'", '"') and re.search(r":(?: |$)", item):
                raise YamlSubsetError(f"mappings inside block lists are not supported: {item!r}")
            seq.append(_value(item))
            pos += 1
        return seq, pos
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        key, rest = _split_key(lines[pos][1])
        pos += 1
        if rest:
            out[key] = _value(rest)
            continue
        nxt = lines[pos] if pos < len(lines) else None
        if nxt is not None and (nxt[0] > indent or (nxt[0] == indent and nxt[1][:2] in ("- ", "-"))):
            out[key], pos = _block(lines, pos, nxt[0])
        else:
            out[key] = None
    return out, pos


def load_yaml(text: str) -> Any:
    """Parse YAML text of the supported subset; the result equals ``yaml.safe_load``'s."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tab indentation is not YAML")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or line.startswith("%"):
            raise YamlSubsetError("document markers and directives are not supported")
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    node, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise YamlSubsetError(f"unexpected indentation at {lines[pos][1]!r}")
    return node


def read_yaml(path) -> Any:
    return load_yaml(Path(path).read_text())


# --- the training configuration (counterpart of bsyolo_tpu/cfg/__init__.py get_cfg) ---------------

DEFAULT_CFG_PATH = CFG_ROOT / "default.yaml"

CFG_FLOAT_KEYS = {"warmup_epochs", "box", "cls", "dfl", "degrees", "shear", "time", "pose", "kobj", "iou_ratio"}
CFG_FRACTION_KEYS = {
    "dropout", "lr0", "lrf", "momentum", "weight_decay", "warmup_momentum", "warmup_bias_lr", "hsv_h", "hsv_s",
    "hsv_v", "translate", "scale", "perspective", "flipud", "fliplr", "bgr", "mosaic", "mixup", "copy_paste", "conf",
    "iou", "fraction",
}
CFG_INT_KEYS = {
    "epochs", "patience", "workers", "seed", "close_mosaic", "mask_ratio", "max_det", "vid_stride", "line_width",
    "nbs", "save_period", "max_gt",
}
CFG_BOOL_KEYS = {
    "save", "exist_ok", "verbose", "deterministic", "single_cls", "rect", "cos_lr", "resume", "amp", "profile",
    "multi_scale", "nwdloss", "overlap_mask", "val", "save_json", "save_hybrid", "half", "dnn", "plots", "show",
    "save_frames", "save_txt", "save_conf", "save_crop", "show_labels", "show_conf", "show_boxes", "stream_buffer",
    "visualize", "augment", "agnostic_nms", "retina_masks", "keras", "optimize", "int8", "dynamic", "simplify", "nms",
}


def _default_cfg() -> dict:
    d = read_yaml(DEFAULT_CFG_PATH) or {}
    return {k: None if isinstance(v, str) and v.lower() == "none" else v for k, v in d.items()}


DEFAULT_CFG_DICT = _default_cfg()


def cfg2dict(cfg) -> dict:
    from types import SimpleNamespace

    if isinstance(cfg, (str, Path)):
        return read_yaml(cfg) or {}
    if isinstance(cfg, SimpleNamespace):
        return vars(cfg)
    return dict(cfg)


def check_dict_alignment(base: dict, custom: dict) -> None:
    """Unknown keys raise SyntaxError with did-you-mean suggestions."""
    import difflib

    msgs = []
    for k in (k for k in custom if k not in base):
        matches = difflib.get_close_matches(k, base.keys(), n=3, cutoff=0.5)
        hint = f" Did you mean {', '.join(repr(m) for m in matches)}?" if matches else ""
        msgs.append(f"'{k}' is not a valid key.{hint}")
    if msgs:
        raise SyntaxError("\n".join(msgs))


def _check_types(cfg: dict) -> dict:
    for k, v in cfg.items():
        if v is None:
            continue
        if k in CFG_FLOAT_KEYS | CFG_FRACTION_KEYS and isinstance(v, (int, float)):
            cfg[k] = float(v)
        elif k in CFG_INT_KEYS and isinstance(v, (int, float)) and not isinstance(v, bool):
            cfg[k] = int(v)
        elif k in CFG_BOOL_KEYS and not isinstance(v, bool):
            if isinstance(v, str) and v.lower() in ("true", "false"):
                cfg[k] = v.lower() == "true"
            else:
                raise TypeError(f"'{k}={v}' must be a bool")
    return cfg


def get_cfg(cfg=None, overrides=None):
    """default.yaml < ``cfg`` < ``overrides`` (a ``cfg=<file>`` override first), type-checked,
    as a namespace."""
    from types import SimpleNamespace

    merged = {**DEFAULT_CFG_DICT, **cfg2dict(DEFAULT_CFG_DICT if cfg is None else cfg)}
    if overrides:
        overrides = cfg2dict(overrides)
        if overrides.get("cfg"):
            merged.update(read_yaml(overrides.pop("cfg")) or {})
        check_dict_alignment(merged, overrides)
        merged.update(overrides)
    for k in ("project", "name"):
        if merged.get(k) is not None:
            merged[k] = str(merged[k])
    return SimpleNamespace(**_check_types(merged))
