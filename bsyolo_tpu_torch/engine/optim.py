"""Optimizer and schedules of the reference training recipe (counterpart of
``bsyolo_tpu/engine/optim.py``).

Three parameter groups (decayed weights, norm weights, biases), Nesterov SGD
with coupled L2 or AdamW with decoupled decay, the 'auto' rule, a linear or
cosine LR lambda and the linear warmup with its own bias ramp. The schedule
scalars are computed on the host in float32, as the JAX step computes them
on the device; the updates run in place on the card with ``torch._foreach_*``
over each group's tensors, and nothing is read back:

    buf   = mu * buf + g (+ wd * p for group 0)
    step  = g + mu * buf                          # Nesterov
    p    -= lr_group * step
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn

F32 = np.float32


class OptimConfig(NamedTuple):
    name: str = "auto"  # SGD | AdamW | auto
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    cos_lr: bool = False
    epochs: int = 100
    nbs: int = 64  # nominal batch size for decay scaling and accumulation


def resolve_auto(cfg: OptimConfig, nc: int, batch: int, nb_per_epoch: int) -> OptimConfig:
    """The reference 'auto' rule: SGD past 10,000 iterations, else AdamW at a fitted lr."""
    if cfg.name != "auto":
        return cfg
    if cfg.epochs * nb_per_epoch > 10000:
        return cfg._replace(name="SGD", lr0=0.01, momentum=0.9)
    lr_fit = round(0.002 * 5 / (4 + nc), 6)
    return cfg._replace(name="AdamW", lr0=lr_fit, momentum=0.9, warmup_bias_lr=0.0)




def param_groups(model: nn.Module) -> Dict[str, int]:
    """Label every parameter 0 (decayed weight), 1 (norm weight) or 2 (bias), by name.

    As the JAX package labels its leaves: a name containing 'bias' is group 2;
    the weight of a norm layer (flax's ``scale``, BatchNorm and GroupNorm alike)
    is group 1; everything else, convolution weights and ELA's
    ``ch_weight``/``sp_weight``/``res_weight`` included, is group 0. The norm
    weights are told apart by the module that owns them, not by their name.
    """
    groups = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            g = 2 if "bias" in pname else 1 if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)) and pname == "weight" else 0
            groups[f"{mname}.{pname}" if mname else pname] = g
    return groups


def scaled_weight_decay(cfg: OptimConfig, batch_size: int, accumulate: int) -> float:
    """weight_decay * batch * accumulate / nbs."""
    return cfg.weight_decay * batch_size * accumulate / cfg.nbs


def lr_lambda(cfg: OptimConfig):
    """Epoch -> LR multiplier, float32."""
    if cfg.cos_lr:
        def lf(e):
            return (F32(1) - np.cos(F32(e) * F32(math.pi) / F32(cfg.epochs))) / F32(2) * F32(cfg.lrf - 1) + F32(1)
    else:
        def lf(e):
            return np.maximum(F32(1) - F32(e) / F32(cfg.epochs), F32(0)) * F32(1.0 - cfg.lrf) + F32(cfg.lrf)
    return lf


def _ramp(ni, nw) -> np.float32:
    return np.clip(F32(ni) / F32(max(nw, 1)), F32(0), F32(1))


def warmup_scalars(cfg: OptimConfig, ni, nw, epoch_f, lf) -> Tuple[float, float, float]:
    """Iteration ``ni``'s (lr_main, lr_bias, momentum), float32 values: through
    ``nw`` warmup iterations the main groups ramp from 0, the bias group from
    ``warmup_bias_lr`` and the momentum from ``warmup_momentum``."""
    base = F32(cfg.lr0) * F32(lf(epoch_f))
    if ni > nw:
        return float(base), float(base), float(F32(cfg.momentum))
    t = _ramp(ni, nw)
    wb = F32(cfg.warmup_bias_lr)
    mom = F32(cfg.warmup_momentum) + t * (F32(cfg.momentum) - F32(cfg.warmup_momentum))
    return float(t * base), float(wb + t * (base - wb)), float(mom)


def warmup_accumulate(ni, nw, nbs_over_batch) -> int:
    """Accumulation count: ramps from 1 to round(nbs / batch) over the warmup."""
    target = max(np.round(F32(nbs_over_batch)), F32(1))
    acc = np.round(F32(1) + _ramp(ni, nw) * (target - F32(1))) if ni <= nw else np.round(target)
    return int(max(acc, F32(1)))


def _by_group(names: List[str], groups: Dict[str, int]):
    out = {0: [], 1: [], 2: []}
    for n in names:
        out[groups[n]].append(n)
    return out


@torch.no_grad()
def sgd_update(params, grads, momentum_buf, groups, lr_main: float, lr_bias: float, mu: float,
               weight_decay: float):
    """One Nesterov SGD step, in place on ``params`` and ``momentum_buf`` (name -> tensor);
    coupled L2 on group 0, ``lr_bias`` for group 2."""
    for g, names in _by_group(list(params), groups).items():
        if not names:
            continue
        p = [params[n] for n in names]
        grad = [grads[n] for n in names]
        buf = [momentum_buf[n] for n in names]
        grad = torch._foreach_add(grad, p, alpha=weight_decay) if g == 0 else list(grad)
        torch._foreach_mul_(buf, mu)
        torch._foreach_add_(buf, grad)
        step = torch._foreach_add(grad, buf, alpha=mu)
        torch._foreach_add_(p, step, alpha=-(lr_bias if g == 2 else lr_main))
    return params, momentum_buf


@torch.no_grad()
def adamw_update(params, grads, m, v, step: float, groups, lr_main: float, lr_bias: float, beta1: float,
                 weight_decay: float, beta2: float = 0.999, eps: float = 1e-8):
    """One AdamW step (decoupled decay on group 0), in place on ``params``, ``m`` and ``v``;
    ``step`` is the 1-based update count for the bias corrections."""
    bc1 = float(F32(1) - F32(beta1) ** F32(step))
    bc2 = float(F32(1) - F32(beta2) ** F32(step))
    for g, names in _by_group(list(params), groups).items():
        if not names:
            continue
        p = [params[n] for n in names]
        grad = [grads[n] for n in names]
        ms, vs = [m[n] for n in names], [v[n] for n in names]
        torch._foreach_mul_(ms, beta1)
        torch._foreach_add_(ms, grad, alpha=1 - beta1)
        torch._foreach_mul_(vs, beta2)
        torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(grad, 1 - beta2), grad))
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_div_(upd, denom)
        if g == 0:
            torch._foreach_add_(upd, p, alpha=weight_decay)
        torch._foreach_add_(p, upd, alpha=-(lr_bias if g == 2 else lr_main))
    return params, m, v


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float = 10.0):
    """Scale the gradients so their global norm is at most ``max_norm``; returns
    (new name -> tensor, the norm before clipping as a () tensor)."""
    names = list(grads)
    g = [grads[n] for n in names]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
    scale = (max_norm / (gnorm + 1e-6)).clamp(max=1.0)
    return dict(zip(names, torch._foreach_mul(g, scale))), gnorm


def ema_decay(updates: int, decay: float = 0.9999, tau: float = 2000.0) -> np.float32:
    """ModelEMA's decay after ``updates`` optimizer steps, in float32."""
    return F32(decay) * (F32(1) - np.exp(-F32(updates) / F32(tau)))


@torch.no_grad()
def ema_update(ema_params, params, updates: int, decay: float = 0.9999, tau: float = 2000.0):
    """ema = d * ema + (1 - d) * params, in place on ``ema_params``; d from ``ema_decay``."""
    d = ema_decay(updates, decay, tau)
    names = list(ema_params)
    e = [ema_params[n] for n in names]
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, torch._foreach_mul([params[n].detach() for n in names], float(F32(1) - d)))
    return ema_params
