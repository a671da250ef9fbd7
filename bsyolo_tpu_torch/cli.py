"""Command line of the port (counterpart of ``bsyolo_tpu/cli.py``), modes train, val and predict:

    python -m bsyolo_tpu_torch train data=car.yaml model=yolo11n.yaml epochs=100 plots=False
    python -m bsyolo_tpu_torch val model=runs/detect/train/weights/best.ckpt data=car.yaml
    python -m bsyolo_tpu_torch predict model=best.ckpt source=images/ conf=0.25 half=True

Arguments are ``key=value`` pairs of ``cfg/default.yaml`` plus ``model``, ``data`` and
``source``; ``device=cpu`` runs on the host (the card is the default). Every other
key goes on to ``YOLO.train``, ``YOLO.val`` or ``YOLO.predict``, which raise on the
options the port does not have yet. The task, if given, is ``detect``. Other modes
and tasks raise, naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import ast
import sys
from typing import Dict, List

from bsyolo_tpu_torch.cfg import DEFAULT_CFG_DICT, check_dict_alignment
from bsyolo_tpu_torch.utils import LOGGER

MODES = {"train", "val", "predict"}
_NOT_PORTED_MODES = {"track": "item 11", "export": "item 15", "benchmark": "item 15"}
_NOT_PORTED_TASKS = {"segment": "item 12", "pose": "item 12", "obb": "item 12", "classify": "item 12"}


def parse_kv(args: List[str]) -> Dict:
    out = {}
    for a in args:
        if "=" not in a:
            raise SyntaxError(f"arguments must be k=v pairs, got '{a}'")
        k, v = a.split("=", 1)
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        elif v.lower() in ("none", "null", ""):
            v = None
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    if v and v[0] in "[(":
                        try:
                            v = ast.literal_eval(v)
                        except (ValueError, SyntaxError):
                            pass
        out[k] = v
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("help", "-h", "--help"):
        print(__doc__)
        return 0
    mode, rest = None, []
    for a in argv:
        if a in MODES or a in _NOT_PORTED_MODES:
            mode = a
        elif a == "detect":
            continue
        elif a in _NOT_PORTED_TASKS:
            raise NotImplementedError(f"task '{a}' is not ported yet (ROADMAP queue 1, {_NOT_PORTED_TASKS[a]})")
        else:
            rest.append(a)
    if mode in _NOT_PORTED_MODES:
        raise NotImplementedError(f"mode '{mode}' is not ported yet (ROADMAP queue 1, {_NOT_PORTED_MODES[mode]})")
    if mode is None:
        raise SyntaxError(f"a mode is required: one of {sorted(MODES)}")
    overrides = parse_kv(rest)
    check_dict_alignment({**DEFAULT_CFG_DICT, "model": None, "data": None, "source": None}, overrides)

    from bsyolo_tpu_torch import YOLO

    model = YOLO(overrides.pop("model", None) or "yolo11n.yaml", device=overrides.pop("device", None))
    if mode == "train":
        metrics = model.train(**overrides)
        if metrics is not None:
            LOGGER.info(f"results: {metrics.results_dict}")
    elif mode == "val":
        metrics = model.val(**{k: v for k, v in overrides.items() if v is not None})
        LOGGER.info(f"results: {metrics.results_dict}")
        print(metrics.results_dict)
    else:
        source = overrides.pop("source", None)
        if source is None:
            raise SyntaxError("predict requires source=<path>")
        results = model.predict(source, **{k: v for k, v in overrides.items() if v is not None})
        LOGGER.info(f"{len(results)} frames processed")
        print(f"{len(results)} frames, {sum(len(r) for r in results)} detections")
    return 0
