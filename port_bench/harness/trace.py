"""A traced window and what it says: ``torch.profiler`` over the units the
harness names by its spans, read back from the exported Chrome trace.

Spans are ``record_function`` ranges the harness opens around its calls
into the program (``server.predict``, ``model.forward``, ``tiling``,
``train.step``, ``trainer.data``); the window itself is the span
``bench.window``. A profiler window loses its first device records, so
the trace opens with spin kernels before the window span. Busy time is
the union of every kernel, copy and fill inside the window.
"""

from __future__ import annotations

import json
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Spans:
    """``record_function`` ranges opened and closed by name, so that a
    range may start in one call and end in another."""

    def __init__(self, on: bool):
        self.on = on
        self.open: Dict[str, object] = {}

    def enter(self, name: str) -> None:
        if self.on:
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self.open[name] = rf

    def exit(self, name: str) -> None:
        rf = self.open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)


class Profiler:
    """Start and stop a device trace around the traced units."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        if torch.cuda.is_available():
            for _ in range(32):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None


def short_name(name: str) -> str:
    """``void nafblk::k2_mma_kernel<64>(...)`` -> ``nafblk::k2_mma_kernel``;
    ``Memcpy HtoD (Pinned -> Device)`` -> ``Memcpy_HtoD``."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name.split(" (")[0].replace(" ", "_")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        name = name.split(stop)[0]
    return name.strip()


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def overlap(merged: List[Tuple[float, float]], a: float, b: float) -> float:
    """Length of ``[a, b]`` covered by sorted disjoint ``merged``."""
    total = 0.0
    for s, e in merged[max(bisect_right(merged, (a, a)) - 1, 0):]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


@dataclass
class Trace:
    window: Tuple[float, float]            # us
    busy: List[Tuple[float, float]]        # merged device intervals
    device: List[dict]                     # device events in the window
    spans: List[dict]                      # harness spans
    ops: List[dict] = field(default_factory=list)
    launch_span: Dict[int, str] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def busy_in_s(self, a: float, b: float) -> float:
        return overlap(self.busy, a, b) / 1e6

    def spans_named(self, name: str) -> List[dict]:
        return [s for s in self.spans if s["name"] == name]

    def device_s(self, pred) -> float:
        return sum(e["dur"] for e in self.device if pred(e)) / 1e6

    def innermost(self, events: List[dict], t: float) -> Optional[str]:
        best = None
        for e in events:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (
                    best is None or e["dur"] < best["dur"]):
                best = e
        return None if best is None else best["name"]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by the span that
        launched them, and the longest idle gaps, by the span and host
        operation they fell in."""
        ops = defaultdict(float)
        for e in self.device:
            span = self.launch_span.get(e.get("args", {}).get(
                "correlation"), "other")
            ops[f"{span}/{short_name(e['name'])}"] += e["dur"] / 1e6
        edges = [self.window[0]] + [x for iv in self.busy for x in iv] \
            + [self.window[1]]
        gaps = sorted(((a, b) for a, b in zip(edges[::2], edges[1::2])
                       if b > a), key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            span = self.innermost(self.spans, mid) or "bench"
            op = self.innermost(self.ops, mid)
            named.append([f"{span}/{op}" if op else span, (b - a) / 1e6])
        return {"device_ops": [[k, v] for k, v in sorted(
                    ops.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": named}


def read_trace(path: str, span_names) -> Optional[Trace]:
    """The window of the exported trace at ``path``; None when it holds
    no window span."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("cat") == "user_annotation"
           and e["name"] == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    clip = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device]
    spans = [e for e in xs if e.get("cat") == "user_annotation"
             and e["name"] in span_names and e["ts"] < w1
             and e["ts"] + e["dur"] > w0]
    ops = [e for e in xs if e.get("cat") == "cpu_op" and e["ts"] < w1
           and e["ts"] + e["dur"] > w0 and e["dur"] < 1e6]
    trace = Trace((w0, w1), merge(clip), device, spans, ops)
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}) and w0 <= e["ts"] <= w1:
            trace.launch_span[e["args"]["correlation"]] = \
                trace.innermost(spans, e["ts"]) or "bench"
    return trace
