"""Command line of the port (counterpart of ``bsyolo_tpu/cli.py``), modes train, val, predict and track:

    python -m bsyolo_tpu_torch train data=car.yaml model=yolo11n.yaml epochs=100 plots=False
    python -m bsyolo_tpu_torch val model=runs/detect/train/weights/best.ckpt data=car.yaml
    python -m bsyolo_tpu_torch val model=best.ckpt data=car.yaml save_json=True save_txt=True save_conf=True
    python -m bsyolo_tpu_torch predict model=best.ckpt source=images/ conf=0.25 half=True
    python -m bsyolo_tpu_torch predict model=best.ckpt source=images/ save_txt=True save_crop=True name=run1
    python -m bsyolo_tpu_torch track model=best.ckpt source=clip.mp4 tracker=bytetrack.yaml
    python -m bsyolo_tpu_torch segment train data=coco8-seg.yaml model=yolo11n-seg.yaml
    python -m bsyolo_tpu_torch pose predict model=runs/pose/train/weights/best.ckpt source=images/
    python -m bsyolo_tpu_torch obb train data=dota8.yaml model=yolo11n-obb.yaml imgsz=1024
    python -m bsyolo_tpu_torch obb val model=runs/obb/train/weights/best.ckpt data=dota8.yaml half=True
    python -m bsyolo_tpu_torch classify train data=<root of class folders> model=yolo11n-cls.yaml imgsz=224

Arguments are ``key=value`` pairs of ``cfg/default.yaml`` plus ``model``, ``data`` and
``source``; ``device=cpu`` runs on the host (the card is the default). Every other
key goes on to ``YOLO.train``, ``YOLO.val``, ``YOLO.predict`` or ``YOLO.track``, which raise on the
options the port does not have yet. The task, if given (as a word or ``task=``), is
``detect``, ``segment``, ``pose``, ``obb`` or ``classify`` and must be the model's; without
``model`` it picks ``yolo11n.yaml``, ``yolo11n-seg.yaml``, ``yolo11n-pose.yaml``,
``yolo11n-obb.yaml`` or ``yolo11n-cls.yaml``. Other modes raise, naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import ast
import sys
from typing import Dict, List

from bsyolo_tpu_torch.cfg import DEFAULT_CFG_DICT, check_dict_alignment
from bsyolo_tpu_torch.utils import LOGGER

MODES = {"train", "val", "predict", "track"}
_NOT_PORTED_MODES = {"export": "item 15", "benchmark": "item 15"}
TASK_MODELS = {"detect": "yolo11n.yaml", "segment": "yolo11n-seg.yaml", "pose": "yolo11n-pose.yaml",
               "obb": "yolo11n-obb.yaml", "classify": "yolo11n-cls.yaml"}


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
    mode, task, rest = None, None, []
    for a in argv:
        if a in MODES or a in _NOT_PORTED_MODES:
            mode = a
        elif a in TASK_MODELS:
            task = a
        else:
            rest.append(a)
    if mode in _NOT_PORTED_MODES:
        raise NotImplementedError(f"mode '{mode}' is not ported yet (ROADMAP queue 1, {_NOT_PORTED_MODES[mode]})")
    if mode is None:
        raise SyntaxError(f"a mode is required: one of {sorted(MODES)}")
    overrides = parse_kv(rest)
    check_dict_alignment({**DEFAULT_CFG_DICT, "model": None, "data": None, "source": None}, overrides)
    task = overrides.pop("task", None) or task

    from bsyolo_tpu_torch import YOLO

    model = YOLO(overrides.pop("model", None) or TASK_MODELS.get(task or "detect", "yolo11n.yaml"), task=task,
                 device=overrides.pop("device", None))
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
            raise SyntaxError(f"{mode} requires source=<path>")
        fn = model.track if mode == "track" else model.predict
        results = fn(source, **{k: v for k, v in overrides.items() if v is not None})
        LOGGER.info(f"{len(results)} frames processed")
        if model.task == "classify":
            print(f"{len(results)} frames, top-1 classes {[r.probs.top1 for r in results]}")
        else:
            print(f"{len(results)} frames, {sum(len(r) for r in results)} detections")
    return 0
