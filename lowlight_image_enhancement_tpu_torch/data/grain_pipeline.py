"""Multi-worker input pipeline (worker processes, host sharding, epochs).

Counterpart of ``lowlight_image_enhancement_tpu/data/grain_pipeline.py``,
which adapts a map-style dataset to ``grain``. The port needs no
``grain``: :func:`make_grain_loader` keeps its signature and builds a
``torch.utils.data.DataLoader`` over the same pieces --

- :class:`IndexSampler`, grain's ``IndexSampler``: the records split into
  ``shard_count`` contiguous shards (``drop_remainder``: equal shards, the
  rest dropped), each epoch's order a permutation seeded by
  ``(seed, epoch)``, ``num_epochs`` epochs (None: forever);
- batches of ``batch_size // num_hosts`` from the flattened stream
  (grain's ``Batch``);
- the collate of ``data/pipeline.py:Loader`` (JAX's ``_StackBatch``):
  the framework's batch dict, stacked (contiguous) NHWC numpy arrays and
  string fields as lists (PyTorch's default collate would turn them into
  tensors and lists of tensors).

Worker processes start with ``spawn`` (no ``fork`` of a process that may
hold CUDA and threads), so the dataset is pickled into each worker. Each
copy would then draw its random crops from the same generator state, and
every worker would repeat the others' crop positions. ``_seed_worker``
gives the copy in worker ``w`` the generator ``default_rng([seed, w])``
(a dataset's ``_rng``, the port's convention for crop and augmentation
draws).
"""

from __future__ import annotations

import functools
import itertools
from typing import Iterator, Optional

import numpy as np
import torch
from torch.utils.data import BatchSampler, DataLoader, Sampler

from lowlight_image_enhancement_tpu_torch.data.pipeline import _stack_batch


class IndexSampler(Sampler):
    """Record indices of one shard over ``num_epochs`` epochs."""

    def __init__(self, num_records: int, *, shard_index: int = 0,
                 shard_count: int = 1, drop_remainder: bool = True,
                 shuffle: bool = True, num_epochs: Optional[int] = None,
                 seed: int = 0):
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} not in "
                             f"[0, {shard_count})")
        if drop_remainder:
            size = num_records // shard_count
            self.start, self.stop = shard_index * size, (shard_index + 1) * size
        else:
            bounds = np.linspace(0, num_records, shard_count + 1).astype(int)
            self.start, self.stop = bounds[shard_index], bounds[shard_index + 1]
        self.shuffle = shuffle
        self.num_epochs = num_epochs
        self.seed = seed

    def epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.start, self.stop)
        if self.shuffle:
            idx = np.random.default_rng([self.seed, epoch]).permutation(idx)
        return idx

    def __iter__(self) -> Iterator[int]:
        epochs = (range(self.num_epochs) if self.num_epochs is not None
                  else itertools.count())
        for epoch in epochs:
            yield from (int(i) for i in self.epoch_order(epoch))

    def __len__(self) -> int:
        if self.num_epochs is None:
            raise TypeError("an endless sampler (num_epochs=None) has no "
                            "length")
        return (self.stop - self.start) * self.num_epochs


def _seed_worker(seed: int, worker_id: int) -> None:
    """Give worker ``worker_id``'s copy of the dataset its own generator."""
    dataset = torch.utils.data.get_worker_info().dataset
    if isinstance(getattr(dataset, "_rng", None), np.random.Generator):
        dataset._rng = np.random.default_rng([seed, worker_id])


def make_grain_loader(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    num_epochs: Optional[int] = None,
    worker_count: int = 0,
    drop_remainder: bool = True,
    num_hosts: int = 1,
    host_id: int = 0,
) -> DataLoader:
    """A loader yielding the framework's batch dicts.

    ``worker_count > 0`` loads items in that many worker processes (the
    dataset must pickle); host sharding mirrors ``Loader(num_hosts=,
    host_id=)``, each host batching ``batch_size // num_hosts`` items."""
    if batch_size % num_hosts != 0:
        raise ValueError("batch_size must divide across hosts")
    sampler = IndexSampler(
        len(dataset), shard_index=host_id, shard_count=num_hosts,
        drop_remainder=drop_remainder, shuffle=shuffle,
        num_epochs=num_epochs, seed=seed)
    workers = int(worker_count)
    return DataLoader(
        dataset,
        batch_sampler=BatchSampler(sampler, batch_size // num_hosts,
                                   drop_last=drop_remainder),
        collate_fn=_stack_batch,
        num_workers=workers,
        worker_init_fn=(functools.partial(_seed_worker, seed) if workers
                        else None),
        multiprocessing_context="spawn" if workers else None,
    )
