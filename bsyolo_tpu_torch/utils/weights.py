"""Weights in and out of the port's graph (counterpart of ``bsyolo_tpu/utils/torch_weights.py``).

The port's modules carry the reference torch parameter names, so JAX
variables map onto them one to one through ``flax_path_to_torch_key``:
``m{i}`` -> ``model.{i}``, ``m_{j}`` -> ``m.{j}``, ``cv2_{i}_{j}`` ->
``cv2.{i}.{j}``, with the exceptions the BS-YOLO graph needs: DWConv's ``dw``
wrapper level is dropped, MSCA's SE convs are ``SEn.conv.0``, ELA's channel
conv is ``ch_att.2``, ``conv0_1``-style strip-conv names stay whole, and ELA's
fusion weights are bare parameters.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _translate_component(comp: str) -> Tuple[str, ...]:
    """One flax path component -> zero or more torch components."""
    if comp == "dw":
        return ()
    m = re.match(r"^m(\d+)$", comp)
    if m:
        return ("model", m.group(1))
    m = re.match(r"^SE(\d)$", comp)
    if m:
        return (f"SE{m.group(1)}", "conv", "0")
    if comp == "ch_conv":
        return ("ch_att", "2")
    m = re.match(r"^([a-zA-Z][a-zA-Z0-9_]*?)((?:_\d+)+)$", comp)
    if m and not re.match(r"^conv\d$", m.group(1)):
        return (m.group(1), *m.group(2).strip("_").split("_"))
    return (comp,)


_LEAF_MAP = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def flax_path_to_torch_key(collection: str, path: Tuple[str, ...]) -> str:
    *parents, leaf = path
    comps = [t for c in parents for t in _translate_component(c)]
    if leaf in ("ch_weight", "sp_weight", "res_weight"):
        return ".".join(comps + [leaf])
    return ".".join(comps + [_LEAF_MAP.get((collection, leaf), leaf)])


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(a: np.ndarray, leaf: str) -> np.ndarray:
    if leaf != "kernel":
        return a
    if a.ndim == 4:  # flax Conv2d (kH, kW, in/g, out) -> torch (out, in/g, kH, kW)
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 3:  # flax Conv1d (k, in/g, out) -> torch (out, in/g, k)
        return a.transpose(2, 1, 0)
    if a.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return a.T
    return a


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables ``{'params': …, 'batch_stats': …}`` as nested dicts of numpy
    arrays -> a torch state_dict for ``load_state_dict(..., strict=True)``."""
    sd = {}
    for collection, tree in variables.items():
        for path, v in _flatten(tree):
            key = flax_path_to_torch_key(collection, path)
            if key in sd:
                raise ValueError(f"two JAX variables map onto {key}")
            sd[key] = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(np.asarray(v), path[-1])))
    return sd


def load_reference_state_dict(path) -> Dict[str, torch.Tensor]:
    """A ``.pt`` state_dict (or ``{'model'|'ema': state_dict}``), loaded with
    ``weights_only=True``; ``dfl.*`` (the fixed DFL projection, a pure function
    here), ``anchors`` and ``strides`` buffers are dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, Mapping) and not all(isinstance(v, torch.Tensor) for v in ckpt.values()):
        ckpt = ckpt.get("ema") or ckpt.get("model")
    if not isinstance(ckpt, Mapping):
        raise ValueError(f"{path}: expected a state_dict of tensors (optionally under 'model' or 'ema')")
    return {
        k: v.float() if v.is_floating_point() else v
        for k, v in ckpt.items()
        if ".dfl." not in f".{k}" and not k.endswith(("anchors", "strides"))
    }
