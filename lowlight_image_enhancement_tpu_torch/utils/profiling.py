"""Profiling and tracing utilities on ``torch.profiler``.

Counterpart of ``lowlight_image_enhancement_tpu/utils/profiling.py``
(which sits on ``jax.profiler``):

- :func:`trace` -- context manager writing a Chrome trace
  (``<log_dir>/trace_<n>.json``) of the enclosed block, the card's
  kernels included where CUDA is available; it clears the recorder
  when it opens;
- :func:`span` / :func:`count` / :func:`record` / :func:`reset` -- the
  program's recorder: named host-time spans and counters, kept only
  while a ``torch.profiler`` runs (below);
- :func:`chained_timeit` -- per-iteration wall time with a forced data
  dependency, ending in ``torch.cuda.synchronize()`` on the card (the
  host otherwise times the enqueue);
- :func:`summarize_trace` -- device time per kernel family from the
  newest trace under a directory (host operations on a CPU-only trace).

**The recorder.** The port opens spans at its layer boundaries (the
server's staging, forward and readback, the tiled blend, the loader's
decode, the Trainer's fetch and step, the step's forward, backward and
optimizer) and counts the pixels it works on. With no profiler running
(``torch.autograd._profiler_enabled()`` false) :func:`span` returns one
shared no-op context and :func:`count` returns at once: one C call and
one thread-local read each, no allocation, no clock read. While a
profiler runs, a span enters ``record_function(name)`` (so it sits in the
Chrome trace on the profiler's clock, around the operators it launched)
and, on exit,
appends ``(name, parent, unit, thread, t0, t1)`` to an in-memory list,
with ``time.perf_counter()`` times; ``count`` adds to a dict. Whether a
span is recorded is decided when it is entered. ``parent`` is the
enclosing recorded span of the same thread; ``unit`` is the request or
iteration the span serves (given by the top-level span, inherited by
the spans inside it). A loader's pool threads record the loads that the
profiled thread submitted (:func:`carried`): their spans carry their
thread id, and are in the list, not in the Chrome trace.
Worker processes (``data/grain_pipeline.py``) record into their own
copy of this module, which the parent never sees.

A span given a CUDA ``device`` also times the card: a pair of
``torch.cuda.Event(enable_timing=True)`` recorded on the device's current
stream at its edges, with no host sync. The record's ``device_s`` is
resolved when :func:`record` is read (it waits for the span's last
event); on the CPU, and for spans without a device, it is None. A span
whose edges lie in two autograd hooks (a backward) is opened and closed
by :func:`open_span` / :func:`close_span`.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import re
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

# spans kept at most between two resets; later ones are not kept
MAX_SPANS = 1 << 18

_profiler_enabled = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    unit: Optional[int]
    thread: int
    t0: float             # time.perf_counter(), s
    t1: float
    device_s: Optional[float] = None   # the card's time, CUDA spans only


_spans: List[SpanRecord] = []
# (index in _spans, start event, end event) of CUDA spans not yet resolved
_pending: List[tuple] = []
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "unit", "parent", "rf", "t0", "events")

    def __init__(self, name: str, unit: Optional[int], device=None):
        self.name, self.unit = name, unit
        self.events = None
        if device is not None and torch.device(device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True),
                           torch.cuda.current_stream(device))

    def open(self, parent: Optional["_Span"]) -> None:
        self.parent = parent.name if parent is not None else None
        if self.unit is None and parent is not None:
            self.unit = parent.unit
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.events is not None:
            self.events[0].record(self.events[2])
        self.t0 = time.perf_counter()

    def close(self, *exc) -> None:
        t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record(self.events[2])
        self.rf.__exit__(*exc)
        rec = SpanRecord(self.name, self.parent, self.unit,
                         threading.get_ident(), self.t0, t1)
        with _lock:
            if len(_spans) < MAX_SPANS:
                if self.events is not None:
                    _pending.append((len(_spans),) + self.events[:2])
                _spans.append(rec)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.open(stack[-1] if stack else None)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _local.stack.pop()
        self.close(*exc)
        return False


def recording() -> bool:
    """Whether spans and counts are kept on this thread: as the thread
    that handed it the work it runs recorded (:func:`carried`), else
    whether a profiler runs on it."""
    handed = getattr(_local, "carried", None)
    return _profiler_enabled() if handed is None else handed


def carried(fn: Callable) -> Callable:
    """``fn``, to run on another thread and record there exactly when this
    thread records now. A profiler records only the thread that started
    it, so a loader's pool threads keep the spans and counts of the loads
    that the consumer submitted while it was profiled, and of no other."""
    on = recording()

    def run(*args, **kwargs):
        was = getattr(_local, "carried", None)
        _local.carried = on
        try:
            return fn(*args, **kwargs)
        finally:
            _local.carried = was
    return run


def span(name: str, unit: Optional[int] = None, device=None):
    """A named host-time span, recorded only while a profiler runs; with a
    CUDA ``device``, its device time too."""
    if not recording():
        return _NO_SPAN
    return _Span(name, unit, device)


def open_span(name: str, unit: Optional[int] = None, device=None) -> _Span:
    """Open a span now, outside any ``with`` block: for edges that lie in
    two callbacks of one thread (autograd hooks). Its parent is the
    thread's innermost open ``with`` span; it is not one itself. The
    caller has checked :func:`recording`."""
    sp = _Span(name, unit, device)
    stack = getattr(_local, "stack", None)
    sp.open(stack[-1] if stack else None)
    return sp


def close_span(sp: _Span) -> None:
    """Close a span of :func:`open_span` and record it."""
    sp.close(None, None, None)


def current_unit() -> Optional[int]:
    """The unit of this thread's innermost open span, else None."""
    stack = getattr(_local, "stack", None)
    return stack[-1].unit if stack else None


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if not recording():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def record() -> Dict[str, object]:
    """A snapshot: ``spans`` (a list of :class:`SpanRecord`, in the order
    they closed; at most ``MAX_SPANS``) and ``counters``. The device time
    of CUDA spans is resolved here, waiting for their last events."""
    with _lock:
        for i, start, end in _pending:
            end.synchronize()
            _spans[i] = _spans[i]._replace(
                device_s=start.elapsed_time(end) / 1e3)
        _pending.clear()
        return {"spans": list(_spans), "counters": dict(_counters)}


def reset() -> None:
    """Forget every recorded span and counter."""
    with _lock:
        _spans.clear()
        _pending.clear()
        _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block and write its Chrome trace under
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len(glob.glob(os.path.join(log_dir, "trace_*.json")))
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n:04d}.json"))


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
