"""Profiling and tracing utilities on ``torch.profiler``.

Counterpart of ``lowlight_image_enhancement_tpu/utils/profiling.py``
(which sits on ``jax.profiler``):

- :func:`trace` -- context manager writing a Chrome trace
  (``<log_dir>/trace_<n>.json``) of the enclosed block, the card's
  kernels included where CUDA is available;
- :func:`annotate` -- a named region on the timeline (``record_function``);
- :func:`chained_timeit` -- per-iteration wall time with a forced data
  dependency, ending in ``torch.cuda.synchronize()`` on the card (the
  host otherwise times the enqueue);
- :func:`summarize_trace` -- device time per kernel family from the
  newest trace under a directory (host operations on a CPU-only trace).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import re
import time
from typing import Callable, Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block and write its Chrome trace under
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len(glob.glob(os.path.join(log_dir, "trace_*.json")))
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n:04d}.json"))


def annotate(name: str):
    """Named region on the profiler timeline."""
    return torch.profiler.record_function(name)


def _sync(x) -> None:
    tensors = x if isinstance(x, (list, tuple)) else [x]
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


def chained_timeit(
    fn: Callable,
    init,
    *,
    chain: Callable = lambda out, prev: out,
    runs: int = 20,
    warmup: int = 3,
) -> float:
    """Per-iteration wall time (ms) with a forced data dependency:
    ``x_{i+1} = chain(fn(x_i), x_i)``, so no repeat can overlap the one
    before it; on the card the clock stops after a synchronize."""
    x = init
    for _ in range(warmup):
        x = chain(fn(x), x)
    _sync(x)
    t0 = time.perf_counter()
    for _ in range(runs):
        x = chain(fn(x), x)
    _sync(x)
    return (time.perf_counter() - t0) / runs * 1e3


def summarize_trace(log_dir: str, top: int = 20) -> Dict[str, float]:
    """Time (ms) per op family from the newest Chrome trace under
    ``log_dir``: the device's kernels, or the host's operators where the
    trace has no device time. Returns ``{family: total_ms}`` sorted
    descending."""
    paths = sorted(glob.glob(f"{log_dir}/**/*.json", recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace .json under {log_dir}")
    with open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X"]
    device = [e for e in spans if e.get("cat") == "kernel"]
    chosen = device or [e for e in spans if e.get("cat") == "cpu_op"]
    fam: collections.Counter = collections.Counter()
    for e in chosen:
        fam[re.sub(r"\.\d+$", "", e["name"])] += e.get("dur", 0)
    return {k: v / 1e3 for k, v in fam.most_common(top)}
