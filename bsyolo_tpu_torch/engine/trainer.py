"""Trainer of the detect, segment, pose and OBB tasks (counterpart of ``bsyolo_tpu/engine/trainer.py``, one process).

Around the train step (``engine/train_step.py``) it does what the JAX
trainer does: the dataset YAML and the graph with the data's classes, the
loaders, the optimizer choice (``resolve_auto``), epochs with
``close_mosaic``, loss items summed on the card and read once per epoch,
validation of the EMA weights with the model's live BatchNorm statistics,
``results.csv``, ``last.ckpt`` (full), ``best.ckpt``, ``epoch{N}.ckpt``,
early stopping, the ``time`` budget, callbacks and ``resume``. Checkpoints
are the JAX package's format (``utils/ckpt.py``): either package resumes the
other's ``last.ckpt``.

Batches leave the loader as numpy; each is copied to the card through pinned
memory and permuted to NCHW uint8 there.

``amp=True``, the default, builds the graph with a bfloat16 compute dtype
(``nn.model.set_compute_dtype``), as the JAX trainer builds its
``dtype=bfloat16`` graph: parameters, gradients, optimizer slots, EMA,
BatchNorm statistics and checkpoints stay float32, with no loss scaling, and
validation runs the same bf16 graph over the float32 EMA parameters.
``assigner_bf16=True`` runs the TAL ranking math in bfloat16.

The graph's head sets the task, as in the JAX trainer: a Segment graph trains
with ``losses/segment.py`` on the loader's overlap-encoded masks (at
1 / ``mask_ratio`` of the image; ``overlap_mask``) and validates with
``SegmentationValidator``, a Pose graph with ``losses/pose.py`` (gains
``pose`` and ``kobj``; the data's ``flip_idx`` for horizontal flips) and
``PoseValidator``, an OBB graph with ``losses/obb.py`` on the loader's
``rboxes`` and ``OBBValidator``. ``amp`` builds their bf16 graph as it builds
Detect's; ``assigner_bf16`` acts on the detection loss only, as in the JAX
package (the task losses rank in float32). Classify graphs train with
``engine/classify.py ClassificationTrainer``.

Options not ported yet raise ``NotImplementedError`` naming their ROADMAP
item: ``plots=True`` and ``profile=True`` and ``batch=-1`` (item 16),
``chunk_steps > 1`` (item 22), more than one process (item 14).
"""

from __future__ import annotations

import csv
import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bsyolo_tpu_torch import select_device
from bsyolo_tpu_torch.cfg import get_cfg, model_yaml_path
from bsyolo_tpu_torch.data import DataLoader, YOLODataset, load_dataset_yaml
from bsyolo_tpu_torch.engine.optim import OptimConfig, resolve_auto
from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
from bsyolo_tpu_torch.engine.validator import DetectionValidator, OBBValidator, PoseValidator, SegmentationValidator
from bsyolo_tpu_torch.losses import DetectionLossConfig
from bsyolo_tpu_torch.nn.model import build_model
from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml
from bsyolo_tpu_torch.utils import LOGGER
from bsyolo_tpu_torch.utils.callbacks import EarlyStopping, default_callbacks
from bsyolo_tpu_torch.utils.ckpt import load_checkpoint, load_weights, save_checkpoint, train_state_from_payload
from bsyolo_tpu_torch.utils.weights import _tree_to_port, jax_paths, load_reference_state_dict, state_dict_from_jax


def refuse_unported(args) -> None:
    """Raise NotImplementedError for the training options the port does not have yet."""
    if args.plots:
        raise NotImplementedError("plots=True is not ported yet (ROADMAP queue 1, item 16); pass plots=False")
    if args.profile:
        raise NotImplementedError("profile=True is not ported yet (ROADMAP queue 1, item 16)")
    if args.batch is not None and int(args.batch) < 1:
        raise NotImplementedError("batch=-1 (autobatch) is not ported yet (ROADMAP queue 1, item 16)")
    if int(getattr(args, "chunk_steps", 0) or 0) > 1:
        raise NotImplementedError("chunk_steps > 1 (a CUDA graph of K steps) is not ported yet (ROADMAP queue 1, "
                                  "item 22)")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("training in more than one process is not ported yet (ROADMAP queue 1, item 14)")


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch -> tensors on ``device``: img NHWC uint8 -> NCHW uint8 (through pinned
    memory where ``device`` is a card), cls as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        if k == "img":  # a contiguous NCHW copy: a permuted view would carry channels-last strides into the graph
            t = t.permute(0, 3, 1, 2).contiguous()
        elif k == "cls":
            t = t.long()
        out[k] = t
    return out


def val_batches(loader, device):
    """Validation batches for ``DetectionValidator``: the image on the card as NCHW, the labels numpy."""
    for b in loader:
        yield {**b, "img": to_device({"img": b["img"]}, device)["img"]}


class DetectionTrainer:
    """Train a detect, segment, pose or OBB graph from a model YAML and a dataset YAML."""

    def __init__(self, overrides: Optional[Dict] = None, callbacks=None):
        self.args = get_cfg(overrides=overrides or {})
        refuse_unported(self.args)
        self.device = select_device(self.args.device)
        self.save_dir = Path(self.args.project or "runs/detect") / (self.args.name or "train")
        self.best_fitness = 0.0
        self.epoch = 0
        self.start_epoch = 0
        self.metrics = None
        self.epoch_metrics = None
        self.callbacks = callbacks or default_callbacks()
        self.stopper = EarlyStopping(self.args.patience)
        self.loader_wait = []  # per epoch: (seconds waiting on the loader, epoch seconds, steps)
        self.first_batch = None  # the first batch the train step received, on the device

    def add_callback(self, event: str, fn):
        self.callbacks.add(event, fn)

    def setup(self):
        args = self.args
        data = self.data = load_dataset_yaml(args.data)
        d = load_model_yaml(model_yaml_path(str(args.model)))
        d["nc"] = data["nc"]
        if data.get("names"):
            d["names"] = data["names"]
        self.spec = parse_model_yaml(d, scale=d.get("scale", ""))
        task = self.spec.task
        if task == "classify":
            raise ValueError(f"{args.model} is a Classify graph: engine/classify.py ClassificationTrainer trains it")
        torch.manual_seed(args.seed)
        dtype = torch.bfloat16 if args.amp else torch.float32
        self.model = build_model(self.spec, self.device, args.seed, dtype=dtype)
        self.paths = jax_paths(self.model)
        if isinstance(args.pretrained, str) and args.pretrained.lower() not in ("true", "false", ""):
            self._load_pretrained(args.pretrained)

        task_kw = dict(task=task, mask_ratio=args.mask_ratio, flip_idx=data.get("flip_idx"))
        train_ds = YOLODataset(data["train"], imgsz=args.imgsz, augment=True, hyp=vars(args), max_gt=args.max_gt,
                               single_cls=args.single_cls, fraction=args.fraction, cache=getattr(args, "cache", False),
                               **task_kw)
        val_ds = YOLODataset(data["val"], imgsz=args.imgsz, augment=False, max_gt=args.max_gt,
                             single_cls=args.single_cls, **task_kw)
        workers = min(int(args.workers or 0), max((os.cpu_count() or 1) - 1, 0))
        self.train_loader = DataLoader(train_ds, args.batch, shuffle=True, seed=args.seed, workers=workers)
        self.val_loader = DataLoader(val_ds, args.batch, shuffle=False, drop_last=False)
        nb = self.nb = max(len(self.train_loader), 1)

        opt = OptimConfig(name=args.optimizer, lr0=args.lr0, lrf=args.lrf, momentum=args.momentum,
                          weight_decay=args.weight_decay, warmup_epochs=args.warmup_epochs,
                          warmup_momentum=args.warmup_momentum, warmup_bias_lr=args.warmup_bias_lr,
                          cos_lr=args.cos_lr, epochs=args.epochs, nbs=args.nbs)
        opt = resolve_auto(opt, self.spec.nc, args.batch, nb)
        accumulate = max(round(args.nbs / args.batch), 1)
        wd = opt.weight_decay * args.batch * accumulate / args.nbs
        loss_cfg = DetectionLossConfig(nc=self.spec.nc, strides=self.spec.head_strides, reg_max=self.spec.reg_max,
                                       box=args.box, cls=args.cls, dfl=args.dfl, nwd_loss=args.nwdloss,
                                       iou_ratio=args.iou_ratio,
                                       assigner_bf16=bool(getattr(args, "assigner_bf16", False)))
        nw = max(round(opt.warmup_epochs * nb), 100) if opt.warmup_epochs > 0 else 0
        self.step_cfg = StepConfig(loss=loss_cfg, optim=opt, batch_size=args.batch, nb=nb, nw=nw,
                                   use_adamw=opt.name in ("AdamW", "Adam", "NAdam", "RAdam"), weight_decay=wd,
                                   frozen=self._frozen_keys(), remat=getattr(args, "remat", False) or False)
        criterion, self.item_names = task_criterion(self.spec, bool(args.overlap_mask), args.pose, args.kobj)
        self.train_step = make_train_step(self.model, self.step_cfg, criterion, self.item_names)
        self.state = init_train_state(self.model, self.step_cfg)
        validator_cls = {"segment": SegmentationValidator, "pose": PoseValidator, "obb": OBBValidator}.get(
            task, DetectionValidator)
        self.validator = validator_cls(self.model, self.spec, names=data.get("names"), device=self.device)
        self.csv_path = self.save_dir / "results.csv"
        self._ms_sizes = None
        if args.multi_scale and task != "detect":
            LOGGER.warning("multi_scale resizes the images but not the task's masks; it is off for the "
                           f"{task} task, as in the JAX trainer")
        elif args.multi_scale:
            self._ms_sizes = sorted({max(32, int(round(args.imgsz * f / 32)) * 32) for f in (0.5, 0.75, 1.0, 1.25, 1.5)})
            LOGGER.info(f"multi_scale: bucketed sizes {self._ms_sizes}")
        if args.resume:
            self._resume()

    def _apply_multi_scale(self, batch, ni: int):
        """The image batch resized on the card to the size drawn for iteration ``ni`` (bilinear on
        [0, 1] floats, antialiased when shrinking); normalized labels need no change."""
        sz = int(self._ms_sizes[np.random.default_rng((self.args.seed, ni)).integers(len(self._ms_sizes))])
        if sz == int(batch["img"].shape[2]):
            return batch
        x = batch["img"].float() / 255.0
        x = F.interpolate(x, size=(sz, sz), mode="bilinear", align_corners=False, antialias=sz < x.shape[2])
        return {**batch, "img": x}

    def _load_pretrained(self, path: str):
        """Warm-start from a .ckpt (EMA weights preferred) or a reference .pt; tensors whose name or
        shape differ keep their fresh init."""
        if path.endswith(".pt"):
            src = load_reference_state_dict(path)
        else:
            payload, _ = load_checkpoint(path)
            params = payload.get("ema_params") if payload.get("ema_params") is not None else payload["params"]
            src = state_dict_from_jax({"params": params, "batch_stats": payload.get("batch_stats") or {}})
        own = self.model.state_dict()
        keep = {k: v for k, v in src.items() if k in own and own[k].shape == v.shape}
        self.model.load_state_dict(keep, strict=False)
        LOGGER.info(f"pretrained {path}: {len(keep)} tensors loaded, "
                    f"{sum(1 for k in self.paths if k not in keep)} kept fresh init")

    def _frozen_keys(self) -> tuple:
        """args.freeze (first N layers, or a list of layer indices) -> the JAX top-level keys ("m0", ...)."""
        fz = getattr(self.args, "freeze", None)
        if not fz:
            return ()
        idxs = range(int(fz)) if isinstance(fz, (int, float)) or str(fz).isdigit() else [
            int(i) for i in (fz if isinstance(fz, (list, tuple)) else str(fz).split(","))]
        layers = {path[0] for _, path in self.paths.values()}
        keys = tuple(sorted(k for k in {f"m{i}" for i in idxs} if k in layers))
        if keys:
            LOGGER.info(f"freezing layers {list(keys)} (no grads, no decay)")
        return keys

    def _resume(self):
        """Restore the full train state of save_dir/weights/last.ckpt, written by either package."""
        last = self.save_dir / "weights" / "last.ckpt"
        if not last.exists():
            LOGGER.warning(f"resume requested but {last} not found; starting fresh")
            return
        payload, meta = load_checkpoint(last)
        if "train_state" in payload:
            self.state = train_state_from_payload(payload["train_state"], self.model)
        else:
            LOGGER.warning(f"{last} lacks a full train state; resuming weights only")
            load_weights(payload, self.model, prefer_ema=False)
            ema = _tree_to_port(payload.get("ema_params") or payload["params"], "params", self.device)
            with torch.no_grad():
                for k, v in ema.items():
                    self.state.ema_params[k].copy_(v)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_fitness = float(meta.get("best_fitness", meta.get("fitness", 0.0)))
        LOGGER.info(f"resumed from {last} at epoch {self.start_epoch}")

    def _meta(self, epoch: int, fitness: float) -> dict:
        return {"epoch": epoch, "fitness": fitness, "best_fitness": self.best_fitness,
                "args": {k: str(v) for k, v in vars(self.args).items()},
                "names": [str(v) for v in (self.data.get("names") or {}).values()],
                "task": self.spec.task, "kpt_shape": list(self.spec.kpt_shape)}

    def train(self):
        self.start_epoch = 0
        self.setup()
        args = self.args
        self.callbacks.run("on_train_start", self)
        LOGGER.info(f"training {args.model} on {args.data}: {args.epochs} epochs, batch {args.batch}, imgsz "
                    f"{args.imgsz}, {len(self.train_loader.dataset)} train images, {self.step_cfg.optim.name} "
                    f"lr0={self.step_cfg.optim.lr0}, on {self.device}")
        t_start = time.time()
        stop_epoch = args.epochs
        try:
            for epoch in range(self.start_epoch, args.epochs):
                self.epoch = epoch
                self.callbacks.run("on_train_epoch_start", self)
                if args.close_mosaic and epoch == max(args.epochs - args.close_mosaic, 0):
                    self.train_loader.close_mosaic()
                self.train_loader.set_epoch(epoch)
                em, n, wait = {}, 0, 0.0
                epoch_t0 = time.perf_counter()
                it = iter(self.train_loader)
                while True:
                    t0 = time.perf_counter()
                    try:
                        host = next(it)
                    except StopIteration:
                        break
                    wait += time.perf_counter() - t0
                    batch = to_device(host, self.device)
                    if self._ms_sizes:
                        batch = self._apply_multi_scale(batch, epoch * self.nb + n)
                    if self.first_batch is None:
                        self.first_batch = batch
                    self.state, m = self.train_step(self.state, batch)
                    n += 1
                    for k, v in m.items():
                        if k.endswith("loss"):  # summed on the card: nothing is read back per step
                            em[k] = em[k] + v if k in em else v.clone()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                em = {k: float(v) / max(n, 1) for k, v in em.items()}
                epoch_wall = time.perf_counter() - epoch_t0
                self.loader_wait.append((wait, epoch_wall, n))
                frac = wait / max(epoch_wall, 1e-9)
                if epoch > self.start_epoch and frac > 0.5 and epoch_wall > 2.0 and not getattr(self, "_warned", False):
                    self._warned = True
                    LOGGER.warning(f"input pipeline underfeeds the device: {wait:.1f}s of the {epoch_wall:.1f}s epoch "
                                   f"({100 * frac:.0f}%) spent waiting on the loader. Try cache='ram' (or 'disk') or "
                                   "more workers")
                self.callbacks.run("on_train_epoch_end", self)
                fitness = 0.0
                if args.val:
                    self.metrics = self.validator(self.state.ema_params, val_batches(self.val_loader, self.device))
                    fitness = self.metrics.fitness
                self._log_epoch(epoch, em, fitness)
                self.epoch_metrics = {"train/" + k: v for k, v in em.items()}
                self.epoch_metrics["fitness"] = fitness
                if self.metrics is not None:
                    self.epoch_metrics.update({k: float(v) for k, v in zip(self.metrics.keys,
                                                                          self.metrics.mean_results())})
                self.callbacks.run("on_fit_epoch_end", self)
                if args.save:
                    improved = fitness >= self.best_fitness
                    if improved:
                        self.best_fitness = fitness
                    meta = self._meta(epoch, fitness)
                    weights = self.save_dir / "weights"
                    save_checkpoint(weights / "last.ckpt", self.state, self.paths, meta, full=True)
                    if improved:
                        save_checkpoint(weights / "best.ckpt", self.state, self.paths, meta)
                    sp = int(getattr(args, "save_period", -1) or -1)
                    if sp > 0 and epoch % sp == 0:
                        save_checkpoint(weights / f"epoch{epoch}.ckpt", self.state, self.paths, meta)
                    self.callbacks.run("on_model_save", self)
                if self.stopper(epoch, fitness):
                    LOGGER.info(f"early stopping at epoch {epoch} (no improvement for {self.stopper.patience} epochs)")
                    stop_epoch = epoch + 1
                    break
                if args.time and (time.time() - t_start) / 3600 > args.time:
                    stop_epoch = epoch + 1
                    break
        finally:
            self.train_loader.close()
        self.callbacks.run("on_train_end", self)
        LOGGER.info(f"done: {stop_epoch} epochs, best fitness {self.best_fitness:.4f}")
        return self.metrics

    def _log_epoch(self, epoch, em, fitness):
        # loss columns in sorted order, as the JAX trainer writes them (its step's metrics are a sorted pytree)
        row = {"epoch": epoch, **{k: round(em[k], 5) for k in sorted(em)}, "fitness": round(fitness, 5)}
        if self.metrics is not None:
            for k, v in zip(self.metrics.keys, self.metrics.mean_results()):
                row[k] = round(float(v), 5)
        self.csv_path.parent.mkdir(parents=True, exist_ok=True)
        write_header = not self.csv_path.exists()
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row.keys()))
            if write_header:
                w.writeheader()
            w.writerow(row)
        items = " ".join(f"{k[:-5]} {em.get(k, 0):.3f}" for k in self.item_names)
        LOGGER.info(f"epoch {epoch}: loss {em.get('loss', 0):.3f} ({items}) fitness {fitness:.4f}")
