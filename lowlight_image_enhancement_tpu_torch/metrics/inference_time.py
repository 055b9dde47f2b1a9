"""Inference latency measurement.

Counterpart of ``lowlight_image_enhancement_tpu/metrics/inference_time.py``
(reference ``metrics/inference_time.py:16-75``: CUDA events, 20 warm-up
and 100 timed runs, a sync before and after, ms per image = total /
(runs * batch)). On CUDA one pair of CUDA events spans the whole timed
loop, after the warm-up and a ``torch.cuda.synchronize()``; on the CPU
``time.perf_counter`` does. The device is CUDA when any tensor argument
lies there.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch
from torch.utils._pytree import tree_leaves


def measure_inference_time(fn: Callable[..., Any], *args, warmup: int = 20,
                           runs: int = 100,
                           batch_size: int = 1) -> Dict[str, float]:
    """Steady-state latency of ``fn(*args)``: ``{"ms_per_image",
    "ms_per_batch", "total_s", "runs", "warmup", "batch_size"}``."""
    if warmup < 0 or runs <= 0 or batch_size <= 0:
        raise ValueError("warmup >= 0, runs > 0, batch_size > 0 required")
    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in tree_leaves(args))

    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(runs):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn(*args)
        total = time.perf_counter() - t0

    ms_per_batch = total * 1e3 / runs
    return {
        "ms_per_image": ms_per_batch / batch_size,
        "ms_per_batch": ms_per_batch,
        "total_s": total,
        "runs": float(runs),
        "warmup": float(warmup),
        "batch_size": float(batch_size),
    }
