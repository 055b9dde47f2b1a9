"""Arithmetic shared by the metric readers under ``port_bench/metrics/``."""

from __future__ import annotations

import math
from statistics import mean
from typing import Callable, List, Optional

from port_bench.harness.counts import PEAK_FLOPS, net_flops


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100.0 * len(ordered)), 1) - 1]


def rate(run) -> Optional[float]:
    """Input Mpix per second over the window (first start to last end)."""
    if not run.units or run.window_s <= 0:
        return None
    return sum(u.pixels for u in run.units) / run.window_s / 1e6


def step_ms(run) -> Optional[float]:
    if run.kind != "train" or not run.units:
        return None
    return run.window_s / len(run.units) * 1e3


def mfu(run) -> Optional[float]:
    """Percent of the dtype's peak: the network's forward FLOPs (x3 for a
    training step) over the window's time."""
    if not run.units or run.window_s <= 0:
        return None
    if run.kind == "train":
        flops = 3 * net_flops(run.step_shape, run.net, run.reference) \
            * len(run.units)
    else:
        if not run.forwards:
            return None
        flops = sum(net_flops(s, run.net, run.reference)
                    for s in run.forwards)
    return 100.0 * flops / run.window_s / PEAK_FLOPS[run.dtype]


def roofline(run, cls: str, kernel: str,
             bound_s: Callable[..., float]) -> Optional[float]:
    """Percent: the least time of the traced calls of port module class
    ``cls`` (``bound_s(*record, dtype, backward=)`` of each call's
    record, the backward too where it ran one) over the device time of
    every kernel whose name holds ``kernel``."""
    calls = run.calls.get(cls)
    if run.trace is None or not calls:
        return None
    device_s = run.trace.device_s(lambda e: kernel in e["name"])
    if device_s <= 0:
        return None
    bound = sum(bound_s(*shape, run.dtype)
                + (bound_s(*shape, run.dtype, backward=True) if bwd else 0.0)
                for *shape, bwd in calls)
    return 100.0 * bound / device_s


def idle_share(run) -> Optional[float]:
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def copy_ms_per_mpix(run) -> Optional[float]:
    if run.trace is None or not run.traced:
        return None
    ms = 1e3 * run.trace.device_s(lambda e: e.get("cat") == "gpu_memcpy")
    if ms <= 0:
        return None
    return ms / (sum(u.pixels for u in run.traced) / 1e6)


def host_ms_per_call(run) -> Optional[float]:
    """Per traced call, its wall time less the device's busy time in it."""
    if run.trace is None:
        return None
    calls = run.trace.spans_named("server.predict")
    if not calls or run.trace.busy_s <= 0:
        return None
    return mean((c["dur"] / 1e6 - run.trace.busy_in_s(
        c["ts"], c["ts"] + c["dur"])) * 1e3 for c in calls)


def mean_ms(values: List[float]) -> Optional[float]:
    return mean(values) * 1e3 if values else None
