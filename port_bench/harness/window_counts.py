"""The yardstick of windowed self-attention's core: its operations and bytes
counted from the math, and the card's time in the program's spans of it.

The core of one window of ``n`` tokens and ``C = heads x d`` channels is,
per head, the logits ``q k^T`` (``n x d`` by ``d x n``) and the weighted
sum ``softmax(.) v`` (``n x n`` by ``n x d``): ``4 n^2 d`` operations
forward (2 a multiply-add), so ``4 n^2 C`` a window over its heads,
whatever the number of heads; the backward computes both products' two
input gradients, ``8 n^2 C``. Bytes count q, k, v in and the output out
once, in the activation type, forward; q, k, v and the output's gradient
in and the gradients of q, k, v out, backward. The bias, the mask and the
softmax are left out of the operations and their tables out of the bytes,
so the bound is a lower bound of the time, as ``counts.py``'s is of a
NAFBlock.

The program records the core as the spans ``swinir.attention`` and
``swinir.attention_bwd``, with the card's time in each record's
``device_s``, and counts the windows it attends (``swinir.windows``).
A program without them gives every reader here None.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

from port_bench.harness import program
from port_bench.harness.counts import (
    ELEMENT_BYTES,
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
)

FORWARD, BACKWARD = "swinir.attention", "swinir.attention_bwd"
WINDOWS = "swinir.windows"


def core_work(windows: int, c: int, n: int, dtype: str,
              backward: bool = False) -> Tuple[float, float]:
    """``(flops, bytes)`` of the core over ``windows`` windows of ``n``
    tokens and ``c`` channels."""
    act = float(windows * n * c * ELEMENT_BYTES[dtype])
    flops = 4.0 * windows * n * n * c
    return (2 * flops, 7 * act) if backward else (flops, 4 * act)


def core_bound_s(windows: int, c: int, n: int, dtype: str,
                 backward: bool = False) -> float:
    """Least time: operations at the dtype's peak against bytes at the HBM
    rate."""
    flops, nbytes = core_work(windows, c, n, dtype, backward)
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def device_s(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Seconds of the card in the recorded spans named ``names``; None
    where none of them carries a device time."""
    names = set(names)
    times = [getattr(s, "device_s", None) for s in rec["spans"]
             if s.name in names]
    times = [t for t in times if t is not None]
    return sum(times) if times else None


def attention_ms(run) -> Optional[float]:
    """Device ms a unit (a traced step) in the core, forward and
    backward."""
    rec = program.record()
    if rec is None or run.kind not in program.UNIT_SPAN:
        return None
    units = sum(s.name == program.UNIT_SPAN[run.kind] for s in rec["spans"])
    dev = device_s(rec, (FORWARD, BACKWARD))
    if not units or dev is None:
        return None
    return 1e3 * dev / units


def attention_roofline(run) -> Optional[float]:
    """Percent: the core's least time over its device time, forward and,
    where the program recorded it, backward."""
    rec = program.record()
    if rec is None:
        return None
    windows = rec["counters"].get(WINDOWS, 0)
    dev = device_s(rec, (FORWARD, BACKWARD))
    if not windows or not dev:
        return None
    c = int(run.net["embed_dim"])
    n = int(run.net.get("window_size", 8)) ** 2
    bound = core_bound_s(windows, c, n, run.dtype)
    if device_s(rec, (BACKWARD,)) is not None:
        bound += core_bound_s(windows, c, n, run.dtype, backward=True)
    return 100.0 * bound / dev
