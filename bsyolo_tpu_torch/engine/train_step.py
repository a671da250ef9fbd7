"""The training step and its carried state (counterpart of ``bsyolo_tpu/engine/train_step.py``).

What the reference loop mutates per iteration (optimizer slots, the gradient
accumulator, EMA weights, BN running statistics, the EMA-Slide counters) is
a ``TrainState``. Its ``params`` and ``batch_stats`` are the model's own
parameters and BatchNorm buffers, which the step updates in place; the rest
are tensors of their own on the same device.

What decides the control flow lives on the host and is known without reading
the card: the iteration ``step``, the warmup length, the accumulation count,
the update decision, the update count for the EMA decay and AdamW's bias
corrections, and the schedule's learning rates and momentum (float32, as the
JAX step computes them). The loss state, the loss and the gradient norm stay
on the card, so a step reads nothing back; read ``metrics["loss"]`` only when
logging.

Train mode runs every Conv in float: the int8 mode applies in eval mode only.
The amp step is this step over a graph whose compute dtype is bfloat16
(``nn.model.set_compute_dtype``): the convolutions cast their float32
weights, so the gradients, slots, EMA and BatchNorm statistics stay float32,
and the loss casts the head's maps to float32; no loss scaling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from bsyolo_tpu_torch.engine import optim as O
from bsyolo_tpu_torch.losses.detect import DetectionLossConfig, LossState, detection_loss, init_loss_state
from bsyolo_tpu_torch.ops.normalize import normalize_image_batch

Tensors = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    step: int  # global iteration ni
    params: Tensors  # the model's parameters, by name, updated in place
    batch_stats: Tensors  # the model's BatchNorm running_mean / running_var, by name
    ema_params: Tensors
    ema_updates: int  # optimizer steps taken (the EMA decay's and AdamW's count)
    slot0: Tensors  # SGD momentum buffer | AdamW m
    slot1: Optional[Tensors]  # AdamW v; None under SGD
    acc_grads: Optional[Tensors]  # None where every step updates (nbs <= batch)
    last_opt_step: int
    loss_state: LossState


class StepConfig(NamedTuple):
    loss: DetectionLossConfig
    optim: O.OptimConfig
    batch_size: int  # global batch size
    nb: int  # batches per epoch (for the epoch fraction of the LR schedule)
    nw: int  # warmup iterations
    use_adamw: bool
    weight_decay: float  # already scaled by batch * accumulate / nbs
    max_grad_norm: float = 10.0
    pass_targets: bool = False  # feed the targets into the model (RT-DETR's denoising queries)
    needs_dropout_rng: bool = False  # the model uses dropout in train mode
    frozen: tuple = ()  # top-level layer keys as the JAX package names them ("m0", ...), kept as they are
    remat: object = False  # recompute the forward in the backward


def frozen_prefixes(frozen) -> Tuple[str, ...]:
    """JAX top-level keys ("m0") -> the port's parameter-name prefixes ("model.0.")."""
    out = []
    for k in frozen:
        if not (k.startswith("m") and k[1:].isdigit()):
            raise ValueError(f"frozen key {k!r} is not a top-level layer key like 'm0'")
        out.append(f"model.{k[1:]}.")
    return tuple(out)


def _batch_stat_buffers(model: nn.Module) -> Tensors:
    return {n: b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))}


def init_train_state(model: nn.Module, cfg: Optional[StepConfig] = None) -> TrainState:
    """The carried state for ``model``, on the model's device. With ``cfg``, slots the
    configured step can never read are left out (None): ``slot1`` exists only for
    AdamW's second moment, and ``acc_grads`` only where accumulation can happen
    (nbs > batch). Without ``cfg`` every slot is allocated."""
    params = dict(model.named_parameters())
    zeros = lambda: {n: torch.zeros_like(p, memory_format=torch.preserve_format).detach() for n, p in params.items()}
    need_slot1 = cfg is None or cfg.use_adamw
    need_acc = cfg is None or cfg.optim.nbs > cfg.batch_size
    dev = next(iter(params.values())).device
    return TrainState(
        step=0,
        params=params,
        batch_stats=_batch_stat_buffers(model),
        ema_params={n: p.detach().clone() for n, p in params.items()},
        ema_updates=0,
        slot0=zeros(),
        slot1=zeros() if need_slot1 else None,
        acc_grads=zeros() if need_acc else None,
        last_opt_step=-1,
        loss_state=init_loss_state(dev),
    )


def make_train_step(model: nn.Module, cfg: StepConfig) -> Callable:
    """(state, batch) -> (state, metrics), one iteration of ``model`` in train mode
    with the detection loss.

    batch: img (B, 3, H, W) uint8 or float in [0, 1], cls (B, M) int, bboxes
    (B, M, 4) normalized xywh, mask (B, M), all on the model's device.

    metrics: loss, box_loss, cls_loss, dfl_loss, lr, grad_norm (0 where the step
    did not update) and updated (1 or 0); the losses and grad_norm are tensors
    on the card.
    """
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP queue 1, item 19)")
    if cfg.pass_targets or cfg.needs_dropout_rng:
        raise NotImplementedError("targets fed into the model and dropout belong to other model families "
                                  "(ROADMAP queue 1, items 12 and 13)")
    lf = O.lr_lambda(cfg.optim)
    groups = O.param_groups(model)
    prefixes = frozen_prefixes(cfg.frozen)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, dict]:
        params = state.params
        frozen = [n for n in params if n.startswith(prefixes)] if prefixes else []
        model.train()
        for p in params.values():
            p.grad = None
        outputs = model(normalize_image_batch(batch["img"]))
        total, items, new_ls = detection_loss(outputs, batch["cls"], batch["bboxes"], batch["mask"],
                                              state.loss_state, cfg.loss)
        total.backward()
        grads = {n: p.grad for n, p in params.items()}
        for n in frozen:
            grads[n].zero_()
        if state.acc_grads is None:  # every step updates: this step's gradients are the update's input
            acc = grads
        else:
            acc = state.acc_grads
            torch._foreach_add_(list(acc.values()), [grads[n] for n in acc])

        ni = state.step
        accumulate = O.warmup_accumulate(ni, cfg.nw, cfg.optim.nbs / cfg.batch_size)
        do_update = ni - state.last_opt_step >= accumulate
        lr_main, lr_bias, mom = O.warmup_scalars(cfg.optim, ni, cfg.nw, np.float32(ni) / np.float32(cfg.nb), lf)

        if do_update:
            clipped, gnorm = O.clip_by_global_norm(acc, cfg.max_grad_norm)
            kept = {n: params[n].detach().clone() for n in frozen}
            if cfg.use_adamw:
                O.adamw_update(params, clipped, state.slot0, state.slot1, state.ema_updates + 1, groups, lr_main,
                               lr_bias, cfg.optim.momentum, cfg.weight_decay)
            else:
                O.sgd_update(params, clipped, state.slot0, groups, lr_main, lr_bias, mom, cfg.weight_decay)
            with torch.no_grad():
                for n, v in kept.items():  # frozen layers keep their values; their slots took the update
                    params[n].copy_(v)
            state.ema_updates += 1
            O.ema_update(state.ema_params, params, state.ema_updates)
            if state.acc_grads is not None:
                torch._foreach_zero_(list(state.acc_grads.values()))
            state.last_opt_step = ni
        else:
            gnorm = torch.zeros((), device=total.device)
        for p in params.values():
            p.grad = None
        state.step = ni + 1
        state.loss_state = new_ls
        metrics = {
            "loss": total.detach(),
            **dict(zip(("box_loss", "cls_loss", "dfl_loss"), items.detach())),
            "lr": lr_main,
            "grad_norm": gnorm,
            "updated": int(do_update),
        }
        return state, metrics

    return step_fn
