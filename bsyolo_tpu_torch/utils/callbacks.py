"""Callback events of the trainer (counterpart of ``bsyolo_tpu/utils/callbacks.py``).

The same hook names as the JAX package and the reference, so a user callback
ports unchanged. The logging integrations (TensorBoard and the others) are
not ported yet (ROADMAP queue 1, item 16): ``default_callbacks`` is empty.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

HOOKS = [
    # trainer
    "on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start", "on_train_epoch_start",
    "on_train_batch_start", "optimizer_step", "on_before_zero_grad", "on_train_batch_end", "on_train_epoch_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end", "on_params_update", "teardown",
    # validator
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    # predictor
    "on_predict_start", "on_predict_batch_start", "on_predict_postprocess_end", "on_predict_batch_end",
    "on_predict_end",
    # exporter
    "on_export_start", "on_export_end",
]


class CallbackRegistry:
    def __init__(self):
        self._cbs: Dict[str, List[Callable]] = defaultdict(list)

    def add(self, event: str, fn: Callable):
        if event not in HOOKS:
            raise KeyError(f"unknown callback event '{event}' (valid: {HOOKS})")
        self._cbs[event].append(fn)

    def run(self, event: str, obj):
        for fn in self._cbs.get(event, []):
            fn(obj)

    def get(self, event: str):
        return list(self._cbs.get(event, []))


def default_callbacks() -> CallbackRegistry:
    return CallbackRegistry()


class EarlyStopping:
    """Stop after ``patience`` epochs without a fitness improvement."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience
