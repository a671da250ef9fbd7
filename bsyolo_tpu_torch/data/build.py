"""Batch loader with background prefetch and worker processes (counterpart of
``bsyolo_tpu/data/build.py``, single host).

Batches are numpy: img (B, H, W, 3) uint8 RGB, cls (B, M) int32, bboxes
(B, M, 4) normalized xywh, mask (B, M), and im_idx (B,) where the loader does
not drop its tail. The stream equals the JAX package's: the epoch's order
comes from ``default_rng(seed + epoch * 1000003)``, each batch's augmentation
from ``default_rng([seed, epoch, batch index])``, so it does not depend on
the number of workers or on which worker assembled a batch.

- ``workers=0``: one background thread assembles ``prefetch`` batches ahead.
- ``workers=N``: a pool of N processes started with ``spawn``, never forked:
  the parent has initialised CUDA and runs threads, and a forked child of
  such a process may hang. Workers import only the data modules' numpy code
  and never touch the card. At most 2N batches are in flight.
- ``rect=True`` (validation, no shuffle): images grouped into three aspect
  buckets (wide, square, tall), each batch letterboxed to its bucket's canvas.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from bsyolo_tpu_torch.data.dataset import YOLODataset

_WORKER_LOADER = None


def _worker_init(loader):
    global _WORKER_LOADER
    _WORKER_LOADER = loader


def _worker_assemble(args):
    bi, idxs, epoch, mosaic = args
    ld = _WORKER_LOADER
    return ld._assemble(idxs, np.random.default_rng([ld.seed, epoch, bi]), mosaic=mosaic)


class DataLoader:
    def __init__(self, dataset: YOLODataset, batch_size: int, shuffle: bool = True, seed: int = 3,
                 drop_last: bool = True, prefetch: int = 2, mosaic: bool = True, workers: int = 0,
                 rect: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.mosaic = mosaic
        try:
            usable = len(os.sched_getaffinity(0))
        except AttributeError:
            usable = os.cpu_count() or 1
        # a worker process on a 1-core host only adds IPC over the prefetch thread
        self.workers = min(workers, usable if usable > 1 else 0) if workers > 0 else 0
        self.rect = rect and not shuffle
        self.epoch = 0
        self._pool = None

    def __getstate__(self):  # what a worker receives: no pool
        state = dict(self.__dict__)
        state["_pool"] = None
        return state

    def _get_pool(self):
        """The worker pool, started at first use and kept across epochs."""
        if self._pool is None:
            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(self.workers, initializer=_worker_init, initargs=(self,))
        return self._pool

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

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch * 1000003)
        return rng.permutation(n) if self.shuffle else np.arange(n)

    def __len__(self):
        if self.rect:
            return len(self._rect_batches())
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def close_mosaic(self):
        """No mosaic from now on (the last ``close_mosaic`` epochs)."""
        self.mosaic = False

    def _assemble(self, idxs, rng, mosaic: Optional[bool] = None) -> Dict[str, np.ndarray]:
        mosaic = self.mosaic if mosaic is None else mosaic
        idxs = np.asarray(idxs)
        src = np.where(idxs < 0, -idxs - 1, idxs)  # wrapped tail rows are stored as -(idx + 1)
        samples = [self.dataset.get_sample(int(i), rng, mosaic=mosaic) for i in src]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        if not self.drop_last:
            batch["im_idx"] = np.where(idxs < 0, -1, idxs).astype(np.int64)
        return batch

    def _batches(self) -> list:
        order = self._epoch_order()
        n = len(order)
        nb = n // self.batch_size
        batches = [order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]
        if not self.drop_last and n % self.batch_size:
            tail = order[nb * self.batch_size :]
            pad = np.resize(order, self.batch_size - len(tail))  # repeats the order where it is shorter than the pad
            batches.append(np.concatenate([tail, -(pad + 1)]))
        return batches

    def _rect_batches(self):
        """[(source indices, im_idx, (h, w) canvas), ...]: batches by aspect bucket, each bucket's
        last batch wrapped within it, its wrapped rows marked im_idx -1."""
        shapes = self.dataset.image_shapes()
        imgsz = self.dataset.imgsz
        short = max(32, int(np.floor(imgsz * 0.75 / 32)) * 32)
        canvases = ((short, imgsz), (imgsz, imgsz), (imgsz, short))  # wide, square, tall
        ar = shapes[:, 0] / np.maximum(shapes[:, 1], 1)
        key = np.where(ar < 0.85, 0, np.where(ar > 1.18, 2, 1))
        out = []
        for b in range(3):
            idxs = np.nonzero(key == b)[0]
            for s in range(0, len(idxs), self.batch_size):
                chunk = idxs[s : s + self.batch_size]
                pad = self.batch_size - len(chunk)
                if pad:
                    src = np.concatenate([chunk, np.resize(idxs, pad)])
                    im_idx = np.concatenate([chunk, -np.ones(pad, np.int64)])
                else:
                    src, im_idx = chunk, chunk.astype(np.int64)
                out.append((src, im_idx, canvases[b]))
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.rect:
            for bi, (src, im_idx, canvas) in enumerate(self._rect_batches()):
                rng = np.random.default_rng([self.seed, self.epoch, bi])
                samples = [self.dataset.get_sample(int(i), rng, mosaic=False, shape=canvas) for i in src]
                batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                batch["im_idx"] = np.asarray(im_idx, np.int64)
                yield batch
            return
        batches = self._batches()
        if self.workers > 0:
            pool = self._get_pool()
            items = [(bi, idxs, self.epoch, self.mosaic) for bi, idxs in enumerate(batches)]
            window = self.workers * 2
            pending = [pool.apply_async(_worker_assemble, (job,)) for job in items[:window]]
            next_submit = window
            while pending:
                yield pending.pop(0).get()
                if next_submit < len(items):
                    pending.append(pool.apply_async(_worker_assemble, (items[next_submit],)))
                    next_submit += 1
            return
        if self.prefetch <= 0:
            for bi, idxs in enumerate(batches):
                yield self._assemble(idxs, np.random.default_rng([self.seed, self.epoch, bi]))
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        error = []

        def worker():
            try:
                for bi, idxs in enumerate(batches):
                    q.put(self._assemble(idxs, np.random.default_rng([self.seed, self.epoch, bi])))
            except Exception as e:  # re-raised in the consumer, not swallowed in the thread
                error.append(e)
            finally:
                q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                if error:
                    raise error[0]
                break
            yield item
