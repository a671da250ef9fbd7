"""Folder-per-class classification data (counterpart of ``bsyolo_tpu/data/classify.py``).

``root/<class>/**/<image>``: classes are the sorted folder names, images the
sorted files under each, read by ``data/imread.py`` (PNG, BMP, JPEG and .npy
without OpenCV) and turned into float32 RGB (imgsz, imgsz, 3) by
``data/photometric.py``: the classify train transform (random resized crop,
flips, RandAugment or HSV jitter, random erasing) or the eval one (shortest
edge resize, centre crop).

``ClassifyLoader`` yields {"img": (B, imgsz, imgsz, 3) float32, "cls": (B,)
int32}. With no workers, one generator per epoch,
``default_rng(seed + epoch * 1000003)``, draws the order and then every
sample's augmentation in turn: the JAX loader's stream. With ``workers=N``
a pool of N spawned processes assembles the batches, each from
``default_rng([seed, epoch, batch index])``, so the stream does not depend on
N (it is not the JAX loader's). A loader that keeps its tail yields a short
last batch, as the JAX loader does.
"""

from __future__ import annotations

import multiprocessing
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from bsyolo_tpu_torch.data.dataset import IMG_FORMATS
from bsyolo_tpu_torch.data.imread import imread
from bsyolo_tpu_torch.data.photometric import classify_eval_transform, classify_train_transform


class ClassificationDataset:
    def __init__(self, root, imgsz: int = 224, augment: bool = True, fliplr: float = 0.5,
                 auto_augment: Optional[str] = None, erasing: float = 0.0, crop_fraction: float = 1.0):
        self.root = Path(root)
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir()) if self.root.is_dir() else []
        if not classes:
            raise FileNotFoundError(f"no class folders under {root}")
        self.class_names: Dict[int, str] = dict(enumerate(classes))
        self.samples: List[Tuple[str, int]] = [
            (str(f), ci) for ci, name in enumerate(classes) for f in sorted((self.root / name).rglob("*"))
            if f.suffix.lower().lstrip(".") in IMG_FORMATS]
        self.imgsz = imgsz
        self.augment = augment
        self.fliplr = fliplr
        self.auto_augment = auto_augment
        self.erasing = erasing
        self.crop_fraction = crop_fraction

    def __len__(self):
        return len(self.samples)

    def get_sample(self, i: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.int32]:
        """(float32 RGB (imgsz, imgsz, 3), class) of sample ``i``; the train transform draws from ``rng``."""
        path, cls = self.samples[i]
        im = imread(path)
        if im is None:
            raise FileNotFoundError(path)
        im = np.ascontiguousarray(im[..., ::-1])  # BGR -> RGB
        if self.augment:
            img = classify_train_transform(im, rng, size=self.imgsz, hflip=self.fliplr, auto_augment=self.auto_augment,
                                           erasing=self.erasing)
        else:
            img = classify_eval_transform(im, size=self.imgsz, crop_fraction=self.crop_fraction)
        return img, np.int32(cls)


_WORKER_LOADER = None


def _worker_init(loader):
    import torch

    global _WORKER_LOADER
    _WORKER_LOADER = loader
    torch.set_num_threads(1)


def _worker_assemble(args):
    bi, idxs, epoch = args
    ld = _WORKER_LOADER
    return ld._assemble(idxs, np.random.default_rng([ld.seed, epoch, bi]))


class ClassifyLoader:
    def __init__(self, dataset: ClassificationDataset, batch_size: int, shuffle: bool = True, seed: int = 3,
                 drop_last: bool = True, workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        try:
            usable = len(os.sched_getaffinity(0))
        except AttributeError:
            usable = os.cpu_count() or 1
        self.workers = min(workers, usable if usable > 1 else 0) if workers > 0 else 0
        self.epoch = 0
        self._pool = None

    def __getstate__(self):  # what a worker receives: no pool
        state = dict(self.__dict__)
        state["_pool"] = None
        return state

    def set_epoch(self, e: int):
        self.epoch = e

    def close(self):
        """Stop the worker pool (idempotent)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _assemble(self, idxs, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        imgs, clss = zip(*(self.dataset.get_sample(int(i), rng) for i in idxs))
        return {"img": np.stack(imgs), "cls": np.stack(clss)}

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch * 1000003)
        n = len(self.dataset)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        batches = [order[bi * self.batch_size : (bi + 1) * self.batch_size] for bi in range(len(self))]
        if self.workers == 0:
            for idxs in batches:
                yield self._assemble(idxs, rng)
            return
        if self._pool is None:
            self._pool = multiprocessing.get_context("spawn").Pool(self.workers, initializer=_worker_init,
                                                                   initargs=(self,))
        jobs = [(bi, idxs, self.epoch) for bi, idxs in enumerate(batches)]
        window = self.workers * 2
        pending = [self._pool.apply_async(_worker_assemble, (job,)) for job in jobs[:window]]
        for job in jobs[window:]:
            yield pending.pop(0).get()
            pending.append(self._pool.apply_async(_worker_assemble, (job,)))
        for p in pending:
            yield p.get()
