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

import pickle
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from bsyolo_tpu_torch.utils import LOGGER


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


def scales_from_jax(scales: Mapping[str, float]) -> Dict[str, float]:
    """Int8 calibration scales keyed as the JAX package keys them (``"m0/conv"``,
    ``"m2/m_0/cv1/conv"``) -> keyed by the port's conv names (``"model.0.conv"``,
    ``"model.2.m.0.cv1.conv"``), for ``set_int8_inference``."""
    return {".".join(t for c in key.split("/") for t in _translate_component(c)): float(v)
            for key, v in scales.items()}


def _from_torch_layout(a: np.ndarray, leaf: str) -> np.ndarray:
    if leaf != "kernel":
        return a
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 3:
        return a.transpose(2, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def _tree_to_port(tree: Mapping, collection: str, device) -> Dict[str, torch.Tensor]:
    """A JAX tree -> name -> tensor on ``device``, each a copy: the step updates them in place."""
    return {flax_path_to_torch_key(collection, path): torch.tensor(_to_torch_layout(np.asarray(v), path[-1]),
                                                                   device=device) for path, v in _flatten(tree)}


def _unflatten_like(like: Mapping, fn, path: Tuple[str, ...] = ()):
    return {k: _unflatten_like(v, fn, path + (k,)) if isinstance(v, Mapping) else fn(path + (k,))
            for k, v in like.items()}


def train_state_from_jax(state, model: torch.nn.Module):
    """A JAX ``TrainState`` -> the port's, for ``model``: its params and batch_stats are
    loaded into the model (every key matched), the EMA parameters, optimizer slots
    and accumulator (None where the JAX state elides them) become tensors on the
    model's device, the counters Python ints, the loss state tensors."""
    from bsyolo_tpu_torch.engine.train_step import TrainState, _batch_stat_buffers
    from bsyolo_tpu_torch.losses.detect import LossState

    plain = lambda t: None if t is None else {k: plain(v) if hasattr(v, "items") else np.asarray(v)
                                              for k, v in t.items()}
    model.load_state_dict(state_dict_from_jax({"params": plain(state.params),
                                               "batch_stats": plain(state.batch_stats)}), strict=True)
    dev = next(model.parameters()).device
    tree = lambda t: None if t is None else _tree_to_port(plain(t), "params", dev)
    return TrainState(
        step=int(state.step),
        params=dict(model.named_parameters()),
        batch_stats=_batch_stat_buffers(model),
        ema_params=tree(state.ema_params),
        ema_updates=int(state.ema_updates),
        slot0=tree(state.slot0),
        slot1=tree(state.slot1),
        acc_grads=tree(state.acc_grads),
        last_opt_step=int(state.last_opt_step),
        loss_state=LossState(updates=torch.tensor(int(state.loss_state.updates), dtype=torch.int32, device=dev),
                             iou_mean=torch.tensor(np.asarray(state.loss_state.iou_mean), dtype=torch.float32,
                                                   device=dev)),
    )


def train_state_to_jax(state, like) -> dict:
    """The inverse of ``train_state_from_jax``, as numpy: a dict with the JAX
    ``TrainState``'s fields, each tree shaped as the same field of ``like`` (a JAX
    state), each leaf the port's tensor in the JAX layout; None where the port
    state has no slot."""

    def tree(tensors, like_tree, collection="params"):
        if tensors is None:
            return None

        def leaf(path):
            t = tensors[flax_path_to_torch_key(collection, path)]
            return np.array(_from_torch_layout(t.detach().cpu().numpy(), path[-1]))  # a copy: the step updates in place

        return _unflatten_like(like_tree, leaf)

    return {
        "step": state.step,
        "params": tree(state.params, like.params),
        "batch_stats": tree(state.batch_stats, like.batch_stats, "batch_stats"),
        "ema_params": tree(state.ema_params, like.params),
        "ema_updates": state.ema_updates,
        "slot0": tree(state.slot0, like.params),
        "slot1": tree(state.slot1, like.params),
        "acc_grads": tree(state.acc_grads, like.params),
        "last_opt_step": state.last_opt_step,
        "loss_state": {"updates": int(state.loss_state.updates), "iou_mean": float(state.loss_state.iou_mean)},
    }


def load_reference_state_dict(path) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` checkpoint's tensors: a state_dict, ``{'model'|'ema': state_dict}``,
    or, as the reference saves them, ``{'model'|'ema': nn.Module}``. The file is loaded
    with ``weights_only=True`` first; where that fails (a pickled module) it is
    unpickled in full, after a warning, as the JAX package does: unpickling runs
    code from the file, so load only checkpoints from sources you trust.
    ``dfl.*`` (the fixed DFL projection, a pure function here), ``anchors`` and
    ``strides`` buffers are dropped."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        LOGGER.warning(f"{path}: weights_only load failed; falling back to full unpickle. "
                       "Only load checkpoints from sources you trust.")
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, Mapping) and not all(isinstance(v, torch.Tensor) for v in ckpt.values()):
        ckpt = ckpt.get("ema") or ckpt.get("model")
    if isinstance(ckpt, torch.nn.Module):
        ckpt = ckpt.state_dict()
    if not isinstance(ckpt, Mapping):
        raise ValueError(f"{path}: expected a state_dict or a module (optionally under 'model' or 'ema')")
    return {
        k: v.detach().float() if v.is_floating_point() else v.detach()
        for k, v in ckpt.items()
        if ".dfl." not in f".{k}" and not k.endswith(("anchors", "strides"))
    }


_NORMS = (torch.nn.BatchNorm2d, torch.nn.GroupNorm)
_LEAF_FROM_TORCH = {"weight": "kernel", "running_mean": "mean", "running_var": "var"}


def jax_paths(model: torch.nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """The inverse of ``flax_path_to_torch_key`` for ``model``'s parameters and BatchNorm
    statistics: torch key -> (collection, flax path), from the port's own module types, so no
    JAX state is needed. Consecutive list indices join their list's name (``cv2.1.0`` ->
    ``cv2_1_0``), ``model.{i}`` is ``m{i}``, DWConv gets its ``dw`` level back, an _SE's
    ``conv.0`` is the SE level itself, ELA's ``ch_att.2`` is ``ch_conv``; a norm's weight is
    ``scale``, a conv's or linear's ``kernel``."""
    mods = dict(model.named_modules())
    out = {}
    names = [n for n, _ in model.named_parameters()] + [n for n, _ in model.named_buffers()
                                                       if n.endswith(("running_mean", "running_var"))]
    for key in names:
        comps = key.split(".")
        leaf, parents = comps[-1], comps[:-1]
        path, i = [], 0
        while i < len(parents):
            prefix = ".".join(parents[:i])
            c = parents[i]
            owner = mods[prefix] if prefix or i == 0 else None
            j = i + 1
            while j < len(parents) and parents[j].isdigit():
                j += 1
            if type(owner).__name__ == "_SE" and c == "conv":
                i = j  # the SE level's own conv
                continue
            if c == "ch_att" and parents[i + 1 : i + 2] == ["2"]:
                path.append("ch_conv")
                i += 2
                continue
            if i == 0 and c == "model":
                path.append("m" + parents[1])
            else:
                path.append("_".join(parents[i:j]))
            if type(mods[".".join(parents[:j])]).__name__ == "DWConv":
                path.append("dw")
            i = j
        module = mods[".".join(parents)]
        collection = "batch_stats" if leaf in ("running_mean", "running_var") else "params"
        if isinstance(module, _NORMS) and leaf == "weight":
            name = "scale"
        elif isinstance(module, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Linear)) or leaf != "weight":
            name = _LEAF_FROM_TORCH.get(leaf, leaf)
        else:
            name = leaf
        out[key] = (collection, tuple(path) + (name,))
    return out


def jax_tree(tensors: Mapping[str, torch.Tensor], paths: Mapping[str, Tuple[str, Tuple[str, ...]]]) -> dict:
    """name -> tensor (the port's layout) -> the nested flax tree of numpy arrays in the JAX layout."""
    tree: dict = {}
    for key, t in tensors.items():
        _, path = paths[key]
        node = tree
        for c in path[:-1]:
            node = node.setdefault(c, {})
        node[path[-1]] = np.array(_from_torch_layout(t.detach().cpu().numpy(), path[-1]))
    return tree
