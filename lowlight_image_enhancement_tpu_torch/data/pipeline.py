"""Batching, shuffling and device prefetch of the input pipeline.

Counterpart of ``lowlight_image_enhancement_tpu/data/pipeline.py`` (the
reference's DataLoader + EnlargedSampler + ``CUDAPrefetcher``,
``basicsr/data/__init__.py:38-138``, ``data_sampler.py``,
``prefetch_dataloader.py``):

- :class:`Loader` -- the JAX package's loader, in the same order: the
  ``np.random.default_rng(seed + epoch)`` permutation, ``enlarge_ratio``,
  ``drop_last``, the per-host stride and the threaded path; it yields
  NHWC numpy batches;
- :func:`epochs` -- one batch stream over epochs, calling ``set_epoch``;
- :func:`prefetch_to_device` -- the device prefetcher: pinned host
  tensors copied on a side CUDA stream ``size`` batches ahead, permuted
  NHWC -> NCHW on the device, handed to the consumer's stream in order.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device


def _stack_batch(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], (np.ndarray, np.floating, float, int)):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals  # strings (pair_id, key)
    return out


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
      num_workers: >0 fetches items on a thread pool (the native decode
        releases the GIL); items keep their order, but a dataset that
        draws random crops draws them in thread order.
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

    def _order(self) -> np.ndarray:
        n = len(self.dataset) * self.enlarge_ratio
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        return order[self.host_id::self.num_hosts]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._order()
        if self.num_workers > 0:
            yield from self._iter_threaded(order)
            return
        batch = []
        for virtual_idx in order:
            batch.append(self.dataset[int(virtual_idx) % len(self.dataset)])
            if len(batch) == self.local_batch:
                yield _stack_batch(batch)
                batch = []
        if batch and not self.drop_last:
            yield _stack_batch(batch)

    def _iter_threaded(self, order: np.ndarray) -> Iterator[Dict[str, Any]]:
        """Items fetched on a thread pool with a bounded lookahead, submitted
        and consumed in order."""
        import concurrent.futures as cf

        lookahead = self.local_batch * max(self.num_workers, 1) * 2
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            futures: collections.deque = collections.deque()
            it = iter(order)

            def submit_next() -> bool:
                try:
                    virtual_idx = next(it)
                except StopIteration:
                    return False
                futures.append(pool.submit(
                    self.dataset.__getitem__,
                    int(virtual_idx) % len(self.dataset)))
                return True

            for _ in range(lookahead):
                if not submit_next():
                    break
            batch = []
            while futures:
                batch.append(futures.popleft().result())
                submit_next()
                if len(batch) == self.local_batch:
                    yield _stack_batch(batch)
                    batch = []
            if batch and not self.drop_last:
                yield _stack_batch(batch)


def epochs(loader: Loader, num_epochs: Optional[int] = None,
           start_epoch: int = 0) -> Iterator[Dict[str, Any]]:
    """Flatten epochs into one batch stream, calling ``set_epoch``.

    ``start_epoch`` resumes the deterministic shuffle sequence mid-run
    (the trainer passes ``resume_iter // len(loader)``)."""
    counter = (range(start_epoch, start_epoch + num_epochs) if num_epochs
               else itertools.count(start_epoch))
    for ep in counter:
        loader.set_epoch(ep)
        yield from loader


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
