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

With ``pass_targets`` (RT-DETR) the batch's padded labels go into the graph, whose decoder builds its
denoising queries from them with noise drawn from a generator the step owns, reseeded from the iteration
(as the JAX step folds the iteration into ``PRNGKey(3)``: one draw per step number, not JAX's bits).

``remat`` recomputes the forward in the backward (``nn/model.py remat_mode``: full, seg, light), the same
step with less memory. ``make_chunked_train_step`` runs K steps over a stacked batch, the same as K calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from bsyolo_tpu_torch.engine import optim as O
from bsyolo_tpu_torch.losses.classify import classification_loss
from bsyolo_tpu_torch.losses.detect import DetectionLossConfig, LossState, detection_loss, init_loss_state
from bsyolo_tpu_torch.losses.detr import rtdetr_loss
from bsyolo_tpu_torch.losses.obb import obb_loss
from bsyolo_tpu_torch.losses.pose import pose_loss
from bsyolo_tpu_torch.losses.segment import segmentation_loss
from bsyolo_tpu_torch.nn.heads import Classify
from bsyolo_tpu_torch.nn.model import remat_mode
from bsyolo_tpu_torch.nn.transformer import RTDETRDecoder
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
    remat: object = False  # recompute the forward in the backward: False, True/'full', 'seg' or 'light' (nn.model.remat_mode)


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


DETECT_ITEMS = ("box_loss", "cls_loss", "dfl_loss")


def detect_criterion(outputs, batch, loss_state: LossState, cfg: DetectionLossConfig):
    return detection_loss(outputs, batch["cls"], batch["bboxes"], batch["mask"], loss_state, cfg)


def e2e_criterion(outputs, batch, loss_state: LossState, cfg: DetectionLossConfig):
    """YOLOv10's end-to-end loss: the detection loss of the one-to-many branch (top-10 assignment) plus
    that of the one-to-one branch (top-1), items summed. Both read the incoming EMA-Slide state and the
    one-to-many term's new state is carried on, as in the JAX trainer."""
    t1, i1, new_ls = detect_criterion(outputs["one2many"], batch, loss_state, cfg)
    t2, i2, _ = detect_criterion(outputs["one2one"], batch, loss_state, cfg._replace(tal_topk=1))
    return t1 + t2, i1 + i2, new_ls


def rtdetr_criterion(outputs, batch, loss_state: LossState, cfg: DetectionLossConfig):
    """RT-DETR's Hungarian-matched loss (``losses/detr.py``); the loss state passes through."""
    total, items = rtdetr_loss(outputs, batch["cls"], batch["bboxes"], batch["mask"])
    return total, items, loss_state


def task_criterion(spec, overlap_mask: bool = True, pose_gain: float = 12.0, kobj_gain: float = 1.0):
    """(criterion, loss item names) of ``spec``'s task, as the JAX trainers pick them: the detection
    loss; for a v10Detect head the end-to-end loss (``e2e_criterion``); for an RTDETRDecoder head the
    DETR loss (items cls, bbox, giou; the step needs ``pass_targets``); the segmentation loss on the
    batch's overlap-encoded ``masks`` (items box, seg, cls, dfl); the pose loss on its ``keypoints``
    (items box, pose, kobj, cls, dfl); the OBB loss on its ``rboxes`` (items box, cls, dfl); the
    cross-entropy of a Classify graph's logits (item cls)."""
    if spec.head.module == "v10Detect":
        return e2e_criterion, DETECT_ITEMS
    if spec.head.module == "RTDETRDecoder":
        return rtdetr_criterion, ("cls_loss", "bbox_loss", "giou_loss")
    if spec.task == "segment":
        nm = spec.head.args[1]

        def criterion(outputs, batch, loss_state, cfg):
            return segmentation_loss(outputs, batch["cls"], batch["bboxes"], batch["mask"], batch["masks"],
                                     loss_state, cfg, nm=nm, overlap=overlap_mask)

        return criterion, ("box_loss", "seg_loss", "cls_loss", "dfl_loss")
    if spec.task == "pose":
        def criterion(outputs, batch, loss_state, cfg):
            return pose_loss(outputs, batch["cls"], batch["bboxes"], batch["mask"], batch["keypoints"], loss_state,
                             cfg, kpt_shape=spec.kpt_shape, pose_gain=pose_gain, kobj_gain=kobj_gain)

        return criterion, ("box_loss", "pose_loss", "kobj_loss", "cls_loss", "dfl_loss")
    if spec.task == "obb":
        def criterion(outputs, batch, loss_state, cfg):
            return obb_loss(outputs, batch["cls"], batch["rboxes"], batch["mask"], loss_state, cfg)

        return criterion, DETECT_ITEMS
    if spec.task == "classify":
        def criterion(outputs, batch, loss_state, cfg):
            return classification_loss(outputs, batch["cls"], loss_state, cfg)

        return criterion, ("cls_loss",)
    return detect_criterion, DETECT_ITEMS


def make_train_step(model: nn.Module, cfg: StepConfig, criterion: Optional[Callable] = None,
                    item_names: Tuple[str, ...] = DETECT_ITEMS) -> Callable:
    """(state, batch) -> (state, metrics), one iteration of ``model`` in train mode
    with ``criterion(outputs, batch, loss_state, loss_cfg) -> (total, items, new loss_state)``,
    the detection loss by default (``task_criterion`` gives the segment and pose ones).

    batch: img (B, 3, H, W) uint8 or float in [0, 1], cls (B, M) int, bboxes
    (B, M, 4) normalized xywh, mask (B, M) (and the task's masks or keypoints),
    all on the model's device.

    metrics: loss, the items under ``item_names`` (box_loss, cls_loss, dfl_loss for
    detect), lr, grad_norm (0 where the step did not update) and updated (1 or 0);
    the losses and grad_norm are tensors on the card.
    """
    criterion = criterion or detect_criterion
    remat = {"remat": mode} if (mode := remat_mode(cfg.remat)) else {}  # validated here, as the JAX step does
    dn_gen = None
    if cfg.pass_targets:  # the denoising draws' generator, reseeded from the iteration
        dn_gen = torch.Generator(device=next(model.parameters()).device)
        for m in model.modules():
            if isinstance(m, RTDETRDecoder):
                m.generator = dn_gen
    dropout_gen = None
    if cfg.needs_dropout_rng:  # the step's own generator, reseeded from the iteration: one mask per step number
        dropout_gen = torch.Generator(device=next(model.parameters()).device)
        for m in model.modules():
            if isinstance(m, Classify):
                m.generator = dropout_gen
    lf = O.lr_lambda(cfg.optim)
    groups = O.param_groups(model)
    prefixes = frozen_prefixes(cfg.frozen)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, dict]:
        params = state.params
        frozen = [n for n in params if n.startswith(prefixes)] if prefixes else []
        model.train()
        for p in params.values():
            p.grad = None
        if dropout_gen is not None:
            dropout_gen.manual_seed((7 << 32) + state.step)
        targets = None
        if dn_gen is not None:
            dn_gen.manual_seed((3 << 32) + state.step)
            targets = {k: batch[k] for k in ("cls", "bboxes", "mask")}
        outputs = model(normalize_image_batch(batch["img"]), targets=targets, **remat)
        total, items, new_ls = criterion(outputs, batch, state.loss_state, cfg.loss)
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
            **dict(zip(item_names, items.detach())),
            "lr": lr_main,
            "grad_norm": gnorm,
            "updated": int(do_update),
        }
        return state, metrics

    return step_fn


def make_chunked_train_step(model: nn.Module, cfg: StepConfig, criterion: Optional[Callable] = None,
                            item_names: Tuple[str, ...] = DETECT_ITEMS) -> Callable:
    """(state, batches) -> (state, metrics): K steps of ``make_train_step`` over a stacked batch, each
    tensor of ``batches`` (K, B, ...) on the model's device (``engine/trainer.py stack_batches``: one
    pinned copy per key). The same as K calls of the step, since warmup, the schedule, accumulation and
    the EMA decay are functions of the step count the state carries (the JAX package's
    ``make_chunked_train_step``, a ``lax.scan`` of its step). ``metrics`` are (K,) float32 tensors on
    the device, stacked without waiting for the device: reading them is left to the caller. A CUDA graph
    of the K steps is later work (ROADMAP queue 2)."""
    step = make_train_step(model, cfg, criterion, item_names)

    def chunk_fn(state: TrainState, batches) -> Tuple[TrainState, dict]:
        runs = []
        for i in range(next(iter(batches.values())).shape[0]):
            state, m = step(state, {n: v[i] for n, v in batches.items()})
            runs.append(m)
        dev = next(iter(batches.values())).device
        return state, {n: _stacked([m[n] for m in runs], dev) for n in runs[0]}

    return chunk_fn


def _stacked(values, device: torch.device) -> torch.Tensor:
    """K per-step metrics -> one (K,) float32 tensor on ``device``; host numbers (lr, updated) go there
    through pinned memory, since a copy from pageable memory waits for the device's queue."""
    if torch.is_tensor(values[0]):
        return torch.stack(values).float()
    t = torch.tensor(values, dtype=torch.float32)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
