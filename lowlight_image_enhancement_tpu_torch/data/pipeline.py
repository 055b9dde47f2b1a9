"""Batching, shuffling and device prefetch of the input pipeline.

Counterpart of ``lowlight_image_enhancement_tpu/data/pipeline.py`` (the
reference's DataLoader + EnlargedSampler + ``CUDAPrefetcher``,
``basicsr/data/__init__.py:38-138``, ``data_sampler.py``,
``prefetch_dataloader.py``):

- :class:`Loader` -- the JAX package's loader, in the same order: the
  ``np.random.default_rng(seed + epoch)`` permutation, ``enlarge_ratio``,
  ``drop_last``, the per-host stride and the threaded path; it yields
  NHWC numpy batches;
- :func:`epochs` -- one batch stream over epochs (:meth:`Loader.stream`),
  which a threaded loader reads ahead across epoch boundaries;
- :func:`prefetch_to_device` -- the device prefetcher: pinned host
  tensors copied on a side CUDA stream ``size`` batches ahead, permuted
  NHWC -> NCHW on the device, handed to the consumer's stream in order.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.utils.profiling import (
    carried,
    count,
    span,
)


def _stack_batch(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], (np.ndarray, np.floating, float, int)):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals  # strings (pair_id, key)
    return out


def splits_draws(dataset) -> bool:
    """Whether ``dataset`` splits an item into ``draw(idx)``, its random
    draws made on the caller's thread, and ``load(idx, draws)``, a pure
    function of both (``SonySIDDataset``)."""
    return (callable(getattr(dataset, "draw", None))
            and callable(getattr(dataset, "load", None)))


# items in flight ahead of the batch being built: prefetch_to_device's
# depth of 2 batches and that batch, so that the prefetcher's pull finds
# its items submitted three pulls earlier
LOOKAHEAD_BATCHES = 3


class Loader:
    """Deterministic shuffling batcher over a map-style dataset.

    Args:
      dataset: object with ``__len__``/``__getitem__`` -> dict.
      batch_size: **global** batch size; with ``num_hosts > 1`` each host
        yields ``batch_size // num_hosts`` items of its strided shard.
      shuffle: epoch-seeded permutation (seed + epoch), reference
        ``EnlargedSampler`` semantics.
      enlarge_ratio: virtual dataset enlargement (modulo indexing).
      drop_last: drop the trailing partial batch (train default).
      num_workers: >0 fetches items on a pool of that many threads (the
        native decode releases the GIL), up to ``LOOKAHEAD_BATCHES``
        batches ahead and across epoch boundaries in :meth:`stream`.
        Items keep their order. A dataset that :func:`splits_draws`
        (``SonySIDDataset``) makes its random draws on the consumer
        thread in item order, the draws of dropped items included, and
        only its loads run on the pool: the batches are the serial
        loader's, bit for bit. Any other dataset's ``__getitem__`` runs on
        the pool whole, so random draws there follow thread timing.

    Under a profiler each item handed to the batcher counts
    ``loader.items``; one whose load had finished when it was asked for
    also counts ``loader.items_ready``, and the wait for any other is a
    ``loader.wait`` span (``utils/profiling.py``).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, enlarge_ratio: int = 1,
                 drop_last: bool = True, num_hosts: int = 1,
                 host_id: int = 0, num_workers: int = 0):
        if batch_size % num_hosts != 0:
            raise ValueError("batch_size must divide evenly across hosts")
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // num_hosts
        self.shuffle = shuffle
        self.seed = seed
        self.enlarge_ratio = max(int(enlarge_ratio), 1)
        self.drop_last = drop_last
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.num_workers = int(num_workers)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) * self.enlarge_ratio
        per_host = n // self.num_hosts
        if self.drop_last:
            return per_host // self.local_batch
        return -(-per_host // self.local_batch)

    def _order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset) * self.enlarge_ratio
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
        else:
            order = np.arange(n)
        return order[self.host_id::self.num_hosts]

    def _plan(self, epoch_ids: Iterable[int]):
        """``(epoch, index, kept, closes)`` for every item the serial
        loader fetches, in its order: ``kept`` is false for the items that
        ``drop_last`` drops, ``closes`` true for an epoch's batch's last."""
        n, b = len(self.dataset), self.local_batch
        for ep in epoch_ids:
            order = self._order(ep)
            kept = len(order) - (len(order) % b if self.drop_last else 0)
            for pos, virtual_idx in enumerate(order):
                yield (ep, int(virtual_idx) % n, pos < kept,
                       (pos + 1) % b == 0 or pos + 1 == kept)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        """One epoch, ``self.epoch``."""
        return self.stream([self.epoch])

    def stream(self, epoch_ids: Iterable[int]) -> Iterator[Dict[str, Any]]:
        """The batches of ``epoch_ids``, in order, as one stream; each
        batch sets ``self.epoch`` to its epoch. With ``num_workers`` one
        pool serves the whole stream; closing the stream, or dropping it,
        shuts the pool down once the loads in flight have finished."""
        if self.num_workers > 0:
            return self._stream_ahead(epoch_ids)
        return self._stream_serial(epoch_ids)

    def _stream_serial(self, epoch_ids) -> Iterator[Dict[str, Any]]:
        batch = []
        for ep, idx, kept, closes in self._plan(epoch_ids):
            item = self.dataset[idx]
            if not kept:
                continue
            count("loader.items", 1)
            batch.append(item)
            if closes:
                self.epoch = ep
                yield _stack_batch(batch)
                batch = []

    def _stream_ahead(self, epoch_ids) -> Iterator[Dict[str, Any]]:
        import concurrent.futures as cf

        ds = self.dataset
        if splits_draws(ds):
            draw, load = ds.draw, ds.load
        else:               # the whole item on the pool
            draw, load = (lambda idx: None), (lambda idx, _: ds[idx])
        plan = self._plan(epoch_ids)
        lookahead = max(self.local_batch * LOOKAHEAD_BATCHES,
                        self.num_workers)
        pool = cf.ThreadPoolExecutor(self.num_workers,
                                     thread_name_prefix="loader")
        futures: collections.deque = collections.deque()

        def submit_next() -> bool:
            for ep, idx, kept, closes in plan:
                draws = draw(idx)
                if kept:
                    futures.append((ep, closes, pool.submit(
                        carried(load), idx, draws)))
                    return True
            return False

        try:
            while len(futures) < lookahead and submit_next():
                pass
            batch = []
            while futures:
                ep, closes, fut = futures.popleft()
                submit_next()
                count("loader.items", 1)
                if fut.done():
                    count("loader.items_ready", 1)
                    batch.append(fut.result())
                else:
                    with span("loader.wait"):
                        batch.append(fut.result())
                if closes:
                    self.epoch = ep
                    yield _stack_batch(batch)
                    batch = []
        finally:
            pool.shutdown(wait=True)


def epochs(loader: Loader, num_epochs: Optional[int] = None,
           start_epoch: int = 0) -> Iterator[Dict[str, Any]]:
    """Flatten epochs into one batch stream (:meth:`Loader.stream`):
    epoch ``e``'s permutation is ``seed + e``'s, so a threaded loader
    reads ahead across epoch boundaries.

    ``start_epoch`` resumes the deterministic shuffle sequence mid-run
    (the trainer passes ``resume_iter // len(loader)``)."""
    counter = (range(start_epoch, start_epoch + num_epochs) if num_epochs
               else itertools.count(start_epoch))
    return loader.stream(counter)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """An NHWC image batch as a contiguous NCHW tensor; other ranks as
    they are."""
    return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t


def prefetch_to_device(batches: Iterator[Mapping[str, Any]],
                       device: Any = "cuda", size: int = 2,
                       drop_keys=("pair_id", "key")
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of NCHW tensors on ``device``, ``size`` batches ahead.

    String entries (``drop_keys``, as in the JAX prefetcher, and any other
    entry that is no numeric array, such as the stereo sets' ``lq_path`` /
    ``gt_path`` lists) are dropped; every 4-D array is an NHWC image batch
    and arrives NCHW.

    On CUDA each array is copied into pinned host memory and from there to
    the device with ``non_blocking=True`` on a side stream, and permuted
    to NCHW on the device, on that stream. A batch is handed over only
    after the consumer's stream waits on its copy event, and every tensor
    records the consumer's stream, so its memory is not reused while the
    step still reads it. A pinned buffer stays referenced until its batch
    is handed over; after that PyTorch's pinned-memory allocator does not
    reuse it before its copy has completed (it records the copy's event).
    On the CPU the batches are plain NCHW tensors."""
    dev = resolve_device(device)

    def numeric(batch) -> Dict[str, np.ndarray]:
        return {k: np.ascontiguousarray(v) for k, v in batch.items()
                if k not in drop_keys and isinstance(v, np.ndarray)
                and v.dtype.kind in "biuf"}

    if dev.type != "cuda":
        for batch in batches:
            yield {k: _nchw(torch.from_numpy(v))
                   for k, v in numeric(batch).items()}
        return

    copy_stream = torch.cuda.Stream(dev)
    queue: collections.deque = collections.deque()

    def put(batch):
        pinned = {k: torch.from_numpy(v).pin_memory()
                  for k, v in numeric(batch).items()}
        with torch.cuda.stream(copy_stream):
            out = {k: _nchw(t.to(dev, non_blocking=True))
                   for k, t in pinned.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done, pinned

    def hand_over(entry):
        out, done, _pinned = entry
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        return out

    for batch in batches:
        queue.append(put(batch))
        if len(queue) > size:
            yield hand_over(queue.popleft())
    while queue:
        yield hand_over(queue.popleft())
