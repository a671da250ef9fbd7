"""The classification task (counterpart of ``bsyolo_tpu/engine/classify.py``).

``ClassificationTrainer`` trains a Classify graph on a folder-per-class root
(``data/<train|val|test>/<class>/<image>``) with the port's train step and the
cross-entropy criterion (``losses/classify.py``), validates the EMA weights
every epoch (``ClassificationValidator``: top-1 and top-5 accuracy) and writes
``last.ckpt`` and ``best.ckpt`` in the JAX package's format, their meta
naming the classes and the task, so ``YOLO(best.ckpt)`` rebuilds the graph
with the data's class count. The graph trains in float32 only: ``amp=True``,
the default, raises (the bf16 graph on task heads is ROADMAP queue 1, item
12). With ``dropout > 0`` the head's dropout draws from a generator the train
step owns. As the JAX classify trainer, it makes no plots and writes no
``results.csv``; ``plots`` and ``profile`` change nothing here.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from bsyolo_tpu_torch import select_device
from bsyolo_tpu_torch.cfg import get_cfg, model_yaml_path
from bsyolo_tpu_torch.data.classify import ClassificationDataset, ClassifyLoader
from bsyolo_tpu_torch.engine.optim import OptimConfig, resolve_auto
from bsyolo_tpu_torch.engine.train_step import StepConfig, init_train_state, make_train_step, task_criterion
from bsyolo_tpu_torch.losses import DetectionLossConfig
from bsyolo_tpu_torch.nn.model import build_model
from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml
from bsyolo_tpu_torch.utils import LOGGER
from bsyolo_tpu_torch.utils.callbacks import default_callbacks
from bsyolo_tpu_torch.utils.ckpt import save_checkpoint
from bsyolo_tpu_torch.utils.weights import jax_paths


class ClassifyMetrics:
    """Top-1 and top-5 accuracy; fitness is their mean."""

    def __init__(self):
        self.top1 = 0.0
        self.top5 = 0.0
        self.speed: Dict[str, float] = {}

    def process(self, correct1: int, correct5: int, total: int):
        self.top1 = correct1 / max(total, 1)
        self.top5 = correct5 / max(total, 1)

    @property
    def fitness(self):
        return (self.top1 + self.top5) / 2

    @property
    def results_dict(self):
        return {"metrics/accuracy_top1": self.top1, "metrics/accuracy_top5": self.top5, "fitness": self.fitness}


def val_root(root) -> Path:
    """The evaluation split of a classification root: ``val``, else ``test``."""
    root = Path(root)
    return root / ("val" if (root / "val").exists() else "test")


class ClassificationValidator:
    """Top-1 and top-5 accuracy of a Classify graph over batches of {"img": (B, H, W, 3) float32 normalized,
    "cls": (B,)}: the logits on ``device``, one copy to the host per batch, ranked there."""

    def __init__(self, model: torch.nn.Module, device=None):
        self.model = model
        self.device = select_device(device)

    @torch.inference_mode()
    def _logits(self, variables: Optional[Mapping[str, torch.Tensor]], img) -> torch.Tensor:
        x = torch.as_tensor(img).to(self.device, non_blocking=True).permute(0, 3, 1, 2).contiguous()  # NHWC in
        was_training = self.model.training
        self.model.eval()
        try:
            if variables:
                return torch.func.functional_call(self.model, dict(variables), (x,), strict=False)
            return self.model(x)
        finally:
            self.model.train(was_training)

    def __call__(self, variables: Optional[Mapping[str, torch.Tensor]], loader) -> ClassifyMetrics:
        """``variables`` overrides the model's tensors by name (the trainer's EMA parameters); None evaluates
        the model as it is."""
        c1 = c5 = total = 0
        t_infer = 0.0
        for batch in loader:
            t0 = time.perf_counter()
            logits = self._logits(variables, batch["img"]).float().cpu().numpy()
            t_infer += time.perf_counter() - t0
            top5 = np.argsort(-logits, axis=-1)[:, :5]
            labels = np.asarray(batch["cls"])
            c1 += int((top5[:, 0] == labels).sum())
            c5 += int((top5 == labels[:, None]).any(-1).sum())
            total += len(labels)
        m = ClassifyMetrics()
        m.process(c1, c5, total)
        m.speed["inference"] = t_infer / max(total, 1) * 1000
        return m


class ClassificationTrainer:
    """Train a classifier from a folder-per-class root ``data`` (overrides as in ``cfg/default.yaml``)."""

    def __init__(self, overrides: Optional[Dict] = None, callbacks=None):
        self.args = get_cfg(overrides=overrides or {})
        if self.args.batch is not None and int(self.args.batch) < 1:
            raise NotImplementedError("batch=-1 (autobatch) is not ported yet (ROADMAP queue 1, item 16)")
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise NotImplementedError("training in more than one process is not ported yet (ROADMAP queue 1, item 14)")
        self.device = select_device(self.args.device)
        self.save_dir = Path(self.args.project or "runs/classify") / (self.args.name or "train")
        self.metrics = None
        self.best_fitness = 0.0
        self.epoch = 0
        self.callbacks = callbacks or default_callbacks()
        self.loader_wait = []  # per epoch: (seconds waiting on the loader, epoch seconds, steps)
        self.first_batch = None  # the first batch the train step received, on the device

    def add_callback(self, event: str, fn):
        self.callbacks.add(event, fn)

    def setup(self):
        args = self.args
        root = Path(args.data)
        aa = getattr(args, "auto_augment", None)
        if aa and str(aa).lower() in ("autoaugment", "augmix"):
            LOGGER.info(f"auto_augment={aa}: using the randaugment op suite")
        train_ds = ClassificationDataset(root / "train", imgsz=args.imgsz, augment=True,
                                         auto_augment=str(aa) if aa else None,
                                         erasing=float(getattr(args, "erasing", 0.0) or 0.0))
        val_ds = ClassificationDataset(val_root(root), imgsz=args.imgsz, augment=False,
                                       crop_fraction=float(getattr(args, "crop_fraction", 1.0) or 1.0))
        self.names = train_ds.class_names
        nc = len(self.names)
        d = load_model_yaml(model_yaml_path(str(args.model)))
        d["nc"], d["names"] = nc, self.names
        spec = parse_model_yaml(d, scale=d.get("scale", ""))
        if spec.task != "classify":
            raise ValueError(f"model {args.model} has a {spec.head.module} head, not a Classify head")
        if args.amp:
            raise NotImplementedError("train(amp=True), the default, runs the bf16 graph, which on a classify graph "
                                      "is not ported yet (ROADMAP queue 1, item 12); pass amp=False")
        dropout = float(getattr(args, "dropout", 0.0) or 0.0)
        if dropout > 0:
            spec = dataclasses.replace(spec, dropout=dropout)
        self.spec = spec
        torch.manual_seed(args.seed)
        self.model = build_model(spec, self.device, args.seed)
        self.paths = jax_paths(self.model)
        workers = min(int(args.workers or 0), max((os.cpu_count() or 1) - 1, 0))
        self.train_loader = ClassifyLoader(train_ds, args.batch, seed=args.seed, workers=workers)
        self.val_loader = ClassifyLoader(val_ds, args.batch, shuffle=False, drop_last=False)
        nb = max(len(self.train_loader), 1)
        opt = resolve_auto(OptimConfig(name=args.optimizer, lr0=args.lr0, lrf=args.lrf, momentum=args.momentum,
                                       weight_decay=args.weight_decay, warmup_epochs=args.warmup_epochs,
                                       cos_lr=args.cos_lr, epochs=args.epochs, nbs=args.nbs), nc, args.batch, nb)
        accumulate = max(round(args.nbs / args.batch), 1)
        self.step_cfg = StepConfig(
            loss=DetectionLossConfig(nc=nc, strides=(8,)),  # not read by the cross-entropy
            optim=opt, batch_size=args.batch, nb=nb,
            nw=max(round(opt.warmup_epochs * nb), 100) if opt.warmup_epochs > 0 else 0,
            use_adamw=opt.name in ("AdamW", "Adam", "NAdam", "RAdam"),
            weight_decay=opt.weight_decay * args.batch * accumulate / args.nbs, needs_dropout_rng=dropout > 0)
        criterion, self.item_names = task_criterion(spec)
        self.train_step = make_train_step(self.model, self.step_cfg, criterion, self.item_names)
        self.state = init_train_state(self.model, self.step_cfg)
        self.validator = ClassificationValidator(self.model, self.device)

    def _meta(self, epoch: int, fitness: float) -> dict:
        return {"epoch": epoch, "fitness": fitness, "best_fitness": self.best_fitness,
                "args": {k: str(v) for k, v in vars(self.args).items()},
                "names": [str(v) for v in self.names.values()], "task": "classify"}

    def train(self) -> ClassifyMetrics:
        from bsyolo_tpu_torch.engine.trainer import to_device

        self.setup()
        args = self.args
        LOGGER.info(f"classify train: {len(self.names)} classes, {len(self.train_loader.dataset)} images, "
                    f"{args.epochs} epochs, on {self.device}")
        self.callbacks.run("on_train_start", self)
        try:
            for epoch in range(args.epochs):
                self.epoch = epoch
                self.callbacks.run("on_train_epoch_start", self)
                self.train_loader.set_epoch(epoch)
                tot, n, wait = None, 0, 0.0
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
                    if self.first_batch is None:
                        self.first_batch = batch
                    self.state, m = self.train_step(self.state, batch)
                    tot = m["loss"] if tot is None else tot + m["loss"]  # summed on the card
                    n += 1
                loss = float(tot) / max(n, 1) if tot is not None else 0.0
                self.loader_wait.append((wait, time.perf_counter() - epoch_t0, n))
                self.callbacks.run("on_train_epoch_end", self)
                self.metrics = self.validator(self.state.ema_params, self.val_loader)
                fitness = self.metrics.fitness
                self.epoch_metrics = {"train/loss": loss, "fitness": fitness, "top1": self.metrics.top1,
                                      "top5": self.metrics.top5}
                self.callbacks.run("on_fit_epoch_end", self)
                LOGGER.info(f"epoch {epoch}: loss {loss:.4f} top1 {self.metrics.top1:.3f} top5 {self.metrics.top5:.3f}")
                if args.save:
                    improved = fitness >= self.best_fitness
                    if improved:
                        self.best_fitness = fitness
                    meta = self._meta(epoch, fitness)
                    save_checkpoint(self.save_dir / "weights" / "last.ckpt", self.state, self.paths, meta)
                    if improved:
                        save_checkpoint(self.save_dir / "weights" / "best.ckpt", self.state, self.paths, meta)
                    self.callbacks.run("on_model_save", self)
        finally:
            self.train_loader.close()
        self.callbacks.run("on_train_end", self)
        return self.metrics
