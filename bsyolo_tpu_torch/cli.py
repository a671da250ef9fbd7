"""Command line of the port (counterpart of ``bsyolo_tpu/cli.py``), modes train, val, predict, track and export:

    python -m bsyolo_tpu_torch train data=car.yaml model=yolo11n.yaml epochs=100 plots=False
    python -m bsyolo_tpu_torch val model=runs/detect/train/weights/best.ckpt data=car.yaml
    python -m bsyolo_tpu_torch val model=best.ckpt data=car.yaml save_json=True save_txt=True save_conf=True
    python -m bsyolo_tpu_torch predict model=best.ckpt source=images/ conf=0.25 half=True
    python -m bsyolo_tpu_torch predict model=best.ckpt source=images/ save_txt=True save_crop=True name=run1
    python -m bsyolo_tpu_torch track model=best.ckpt source=clip.mp4 tracker=bytetrack.yaml
    python -m bsyolo_tpu_torch predict model=best.ckpt source=clip.mp4 save_frames=True show_conf=False
    python -m bsyolo_tpu_torch segment train data=coco8-seg.yaml model=yolo11n-seg.yaml
    python -m bsyolo_tpu_torch pose predict model=runs/pose/train/weights/best.ckpt source=images/
    python -m bsyolo_tpu_torch obb train data=dota8.yaml model=yolo11n-obb.yaml imgsz=1024
    python -m bsyolo_tpu_torch obb val model=runs/obb/train/weights/best.ckpt data=dota8.yaml half=True
    python -m bsyolo_tpu_torch classify train data=<root of class folders> model=yolo11n-cls.yaml imgsz=224
    python -m bsyolo_tpu_torch train data=car.yaml model=yolov10n.yaml epochs=100 plots=False
    python -m bsyolo_tpu_torch train data=car.yaml model=rtdetr-l.yaml epochs=100 plots=False
    python -m bsyolo_tpu_torch export model=best.ckpt format=pt2 imgsz=640 batch=4
    python -m bsyolo_tpu_torch export model=best.ckpt format=onnx imgsz=320 nms=True
    python -m bsyolo_tpu_torch val model=best.pt2 data=car.yaml        # artifact val (also .pt2-int8, .onnx)

and the verbs of the JAX command line:

    python -m bsyolo_tpu_torch version | cfg | checks | settings | copy-cfg | help
    python -m bsyolo_tpu_torch settings datasets_dir=/data/datasets
    python -m bsyolo_tpu_torch settings reset

Arguments are ``key=value`` pairs of ``cfg/default.yaml`` plus ``model``, ``data`` and
``source``; ``device=cpu`` runs on the host (the card is the default). Every other
key goes on to ``YOLO.train``, ``YOLO.val``, ``YOLO.predict`` or ``YOLO.track``, which raise on the
options the port does not have yet; ``predict`` and ``track`` save their drawings and log each
frame unless ``save=False`` or ``verbose=False`` say otherwise. The task, if given (as a word or ``task=``), is
``detect``, ``segment``, ``pose``, ``obb`` or ``classify`` and must be the model's; without
``model`` it picks ``yolo11n.yaml``, ``yolo11n-seg.yaml``, ``yolo11n-pose.yaml``,
``yolo11n-obb.yaml`` or ``yolo11n-cls.yaml``. Other modes raise, naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import ast
import json
import shutil
import sys
from pathlib import Path
from typing import Dict, List

from bsyolo_tpu_torch.cfg import DEFAULT_CFG_DICT, DEFAULT_CFG_PATH, check_dict_alignment, dump_yaml
from bsyolo_tpu_torch.utils import LOGGER

MODES = {"train", "val", "predict", "track", "export"}
_NOT_PORTED_MODES = {"benchmark": "item 16", "solutions": "item 16"}
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
    if argv[0] in _VERBS:
        return _VERBS[argv[0]](argv[1:])
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
    elif mode == "export":  # the JAX command line's arguments: format, imgsz, nms (and batch)
        out = model.export(format=overrides.get("format") or "pt2", imgsz=overrides.get("imgsz"),
                           batch=int(overrides.get("batch") or 1), nms=bool(overrides.get("nms", False)))
        LOGGER.info(f"exported: {out}")
        print(out)
    else:
        source = overrides.pop("source", None)
        if source is None:
            raise SyntaxError(f"{mode} requires source=<path>")
        overrides.setdefault("save", True)
        overrides.setdefault("verbose", True)
        fn = model.track if mode == "track" else model.predict
        results = fn(source, **{k: v for k, v in overrides.items() if v is not None})
        LOGGER.info(f"{len(results)} frames processed")
        if model.task == "classify":
            print(f"{len(results)} frames, top-1 classes {[r.probs.top1 for r in results]}")
        else:
            print(f"{len(results)} frames, {sum(len(r) for r in results)} detections")
    return 0


def _version(args) -> int:
    from bsyolo_tpu_torch import __version__

    print(__version__)
    return 0


def _cfg(args) -> int:
    """``cfg/default.yaml``'s settings as YAML (the text ``yaml.safe_dump`` gives, as the JAX command line prints)."""
    print(dump_yaml(DEFAULT_CFG_DICT))
    return 0


def _checks(args) -> int:
    """The port's version, torch's, and the CUDA devices torch sees."""
    import torch

    from bsyolo_tpu_torch import __version__

    devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())]
    print(f"bsyolo_tpu_torch {__version__}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), devices: {devices or ['cpu']}")
    return 0


def _settings(args) -> int:
    """View the shared settings, ``reset`` them, or update them from ``k=v`` pairs (unknown keys raise)."""
    from bsyolo_tpu_torch.utils.settings import SettingsManager

    s = SettingsManager()
    if args and args[0] == "reset":
        s.reset()
        LOGGER.info("settings reset to defaults")
    elif args:
        s.update(parse_kv(args))
    print(json.dumps(dict(s), indent=2))
    return 0


def _copy_cfg(args) -> int:
    """Copy ``cfg/default.yaml`` to ``default_copy.yaml`` in the working directory, to edit and pass as ``cfg=``."""
    dst = Path.cwd() / "default_copy.yaml"
    shutil.copy2(DEFAULT_CFG_PATH, dst)
    LOGGER.info(f"copied default cfg to {dst} — use with: cfg={dst.name}")
    return 0


_VERBS = {"version": _version, "cfg": _cfg, "checks": _checks, "settings": _settings, "copy-cfg": _copy_cfg}
