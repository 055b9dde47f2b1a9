"""The window-attention readers (``swin_attention_ms.train``,
``swin_attention_roofline.train``; ``port_bench/harness/window_counts.py``)
on hand-made records of the program: known values where the spans carry
the card's time, None where they carry none (a CPU run), where the
program recorded no such span or counter (the parent of this metric), and
in a served run."""

from collections import namedtuple

import pytest

from port_bench.harness import program, window_counts
from port_bench.harness.record import Run
from port_bench.harness.spec import metric_reader

Span = namedtuple("Span", "name parent unit thread t0 t1 device_s")
OldSpan = namedtuple("OldSpan", "name parent unit thread t0 t1")
NET = {"embed_dim": 180, "window_size": 8, "num_heads": [6] * 6}
WINDOWS = 2 * 36 * 2048      # two steps of 36 blocks of 2 x 256^2 / 64


def record(fwd_s, bwd_s, steps=2, windows=WINDOWS):
    spans = []
    for unit in range(1, steps + 1):
        spans += [Span("swinir.attention", "train_step.forward", unit, 1,
                       0.0, 0.001, fwd_s),
                  Span("swinir.attention_bwd", None, unit, 2, 0.0, 0.002,
                       bwd_s),
                  Span("trainer.step", None, unit, 1, 0.0, 0.4, None)]
    return {"spans": spans, "counters": {"swinir.windows": windows}}


def read(name, monkeypatch, rec, kind="train"):
    monkeypatch.setattr(program, "record", lambda: rec)
    return metric_reader(name)(Run(kind, "bfloat16", NET))


def test_core_work_by_hand():
    # one window of 64 tokens at C = 180: 4 n^2 C forward, 8 n^2 C back;
    # q, k, v, out (forward) and q, k, v, dO, dq, dk, dv (backward) bf16
    assert window_counts.core_work(1, 180, 64, "bfloat16") == (
        4 * 64 * 64 * 180, 4 * 64 * 180 * 2)
    assert window_counts.core_work(1, 180, 64, "bfloat16", True) == (
        8 * 64 * 64 * 180, 7 * 64 * 180 * 2)
    # memory-bound at n = 64: 4 n^2 C operations over 8 n C bytes is n / 2
    # = 32 a byte forward, under the H100's 989e12 / 3.35e12 = 295
    flops, nbytes = window_counts.core_work(WINDOWS, 180, 64, "bfloat16")
    assert window_counts.core_bound_s(WINDOWS, 180, 64, "bfloat16") == \
        pytest.approx(nbytes / 3.35e12)
    assert flops / nbytes == pytest.approx(32.0)


def test_attention_ms_is_device_time_a_step(monkeypatch):
    got = read("swin_attention_ms.train", monkeypatch, record(0.020, 0.050))
    assert got == pytest.approx(1e3 * (0.020 + 0.050))


def test_roofline_is_least_time_over_device_time(monkeypatch):
    got = read("swin_attention_roofline.train", monkeypatch,
               record(0.020, 0.050))
    fwd = 4 * WINDOWS * 64 * 180 * 2 / 3.35e12
    bwd = 7 * WINDOWS * 64 * 180 * 2 / 3.35e12
    assert got == pytest.approx(100 * (fwd + bwd) / (2 * (0.020 + 0.050)))
    # a forward alone (no backward recorded) is held to the forward's bound
    rec = record(0.020, 0.050)
    rec["spans"] = [s for s in rec["spans"]
                    if s.name != "swinir.attention_bwd"]
    got = read("swin_attention_roofline.train", monkeypatch, rec)
    assert got == pytest.approx(100 * fwd / (2 * 0.020))


@pytest.mark.parametrize("name", ["swin_attention_ms.train",
                                  "swin_attention_roofline.train"])
def test_nothing_to_read_reads_none(monkeypatch, name):
    assert read(name, monkeypatch, record(None, None)) is None
    assert read(name, monkeypatch, record(0.02, 0.05), kind="serve") is None
    assert read(name, monkeypatch, None) is None
    assert read(name, monkeypatch, {"spans": [], "counters": {}}) is None
    # a program whose records have no device field, and no such spans
    old = {"spans": [OldSpan("trainer.step", None, 1, 1, 0.0, 0.4)],
           "counters": {}}
    assert read(name, monkeypatch, old) is None
