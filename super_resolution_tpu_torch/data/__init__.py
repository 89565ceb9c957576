"""Dataset factory and loaders (port of super_resolution_tpu/data/
__init__.py; ref: basicsr/data/__init__.py:25-94, data_sampler.py:8-50,
prefetch_dataloader.py:7-36).

The loaders are plain iterators, not ``torch.utils.data.DataLoader``s with
workers, so that the order, the crops and the arrays are the JAX package's
exactly. The train loader walks an epoch-seeded permutation with
``EnlargedSampler``'s modulo wrap, reseeds the dataset's crops every epoch
and loads ahead on one background thread; val and test loaders are
sequential and batch 1. Training runs in one process: a device mesh
raises."""

from __future__ import annotations

import queue
import threading
from copy import deepcopy
from typing import Iterator

import numpy as np

from super_resolution_tpu_torch.data import (  # noqa: F401 registry
    onthefly_datasets, paired_dataset, rawpack_dataset, realesrgan_dataset,
    video_datasets)
from super_resolution_tpu_torch.utils.registry import DATASET_REGISTRY


def build_dataset(dataset_opt: dict):
    dataset_opt = deepcopy(dataset_opt)
    return DATASET_REGISTRY.get(dataset_opt["type"])(dataset_opt)


class EnlargedSampler:
    """Epoch-seeded permutation over len * ratio indices (rounded up to a
    multiple of the ranks), wrapped modulo the dataset's length; rank r
    takes every world_size-th index from r (ref: data_sampler.py:31-44)."""

    def __init__(self, num_samples: int, ratio: float = 1,
                 world_size: int = 1, rank: int = 0):
        self.num_samples = num_samples
        self.world_size, self.rank = world_size, rank
        self.total_size = (int(np.ceil(num_samples * ratio / world_size))
                           * world_size)
        self.per_rank = self.total_size // world_size
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        g = np.random.default_rng(self.epoch)
        idx = g.permutation(self.total_size) % self.num_samples
        return idx[self.rank:self.total_size:self.world_size]


class PrefetchIterator:
    """Runs a generator on a background thread, a few items ahead (ref:
    prefetch_dataloader.py:7-36). An exception in the generator is raised
    in the consumer; :meth:`close` ends the thread where the consumer stops
    early."""

    _END = object()

    def __init__(self, gen: Iterator, num_prefetch: int = 2):
        self._queue: queue.Queue = queue.Queue(num_prefetch)
        self._gen = gen
        self._error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._gen:
                self._queue.put(item)
                if self._stop.is_set():
                    break
        except Exception as exc:  # handed to the consumer in __next__
            self._error = exc
        finally:
            self._queue.put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._END:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        """Stops the worker after the item it is making and drops what it
        made, so that neither the thread nor its batches outlive the
        consumer."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()
        with self._queue.mutex:
            self._queue.queue.clear()


class TrainLoader:
    """Batches of ``batch_size`` in EnlargedSampler order; an epoch yields
    ``len(self)`` of them."""

    def __init__(self, dataset, batch_size: int, ratio: float = 1,
                 seed: int = 0, world_size: int = 1, rank: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = EnlargedSampler(len(dataset), ratio, world_size, rank)
        self.seed = seed

    def __len__(self):
        return self.sampler.per_rank // self.batch_size

    def epoch_iter(self, epoch: int, start: int = 0):
        """The batches of one epoch from batch ``start`` on. The batches
        before ``start`` are still loaded, so that the dataset's crops and
        flips from there on are those of an epoch read whole (a run resumed
        in the middle of an epoch goes on where it stopped)."""
        self.sampler.set_epoch(self.seed + epoch)
        if hasattr(self.dataset, "seed"):
            self.dataset.seed(self.seed + epoch * 7919 + self.sampler.rank)

        def gen():
            idx = self.sampler.indices()
            for b in range(len(idx) // self.batch_size):
                items = [self.dataset[int(i)] for i in
                         idx[b * self.batch_size:(b + 1) * self.batch_size]]
                if b >= start:
                    yield collate(items)

        return PrefetchIterator(gen())


class EvalLoader:
    """Sequential batch-1 loader (val/test, ref: data/__init__.py:84-94)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield collate([self.dataset[i]])


def collate(items: list) -> dict:
    """A batch of dataset items: arrays stacked on a new leading axis,
    other values listed."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


def build_dataloader(dataset, dataset_opt: dict, seed: int = 0, mesh=None):
    """The loader of a dataset: for phase ``train`` a :class:`TrainLoader` of
    ``batch_size_per_gpu`` (per device, as the reference's per GPU: the
    global batch is that times the ``data`` axis), seeded with ``seed``;
    with a ``mesh``, rank r of its ``data`` axis loads the r-th share of
    each epoch (the ranks of a ``model`` or ``pipe`` axis load the same
    batch); for a val or test set an :class:`EvalLoader`."""
    if dataset_opt["phase"] == "train":
        from super_resolution_tpu_torch.parallel.mesh import (axis_rank,
                                                              axis_size)

        return TrainLoader(
            dataset, batch_size=dataset_opt["batch_size_per_gpu"],
            ratio=dataset_opt.get("dataset_enlarge_ratio", 1), seed=seed,
            world_size=axis_size(mesh, "data"), rank=axis_rank(mesh, "data"))
    return EvalLoader(dataset)
