"""The reader of ``data_ready_share.train``
(``port_bench/metrics/data_ready_share.train.py``): the share of the items
the Trainer's loader handed over already loaded, from the program's
counters ``loader.items_ready`` and ``loader.items``; None in a serve
cell, where nothing was counted, and for a package without the counters
or the recorder."""

import json
from pathlib import Path

import pytest

from port_bench.harness import program
from port_bench.harness.record import Run
from port_bench.harness.spec import metric_reader

NAME = "data_ready_share.train"
BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())


def test_the_metric_is_declared_for_both_training_cells():
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "train_step_ms"
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert set(entry["workloads"]) == {"newbp_w64.train_subimg512",
                                       "newbp_w32.train_sid384"}


@pytest.mark.parametrize("counters,want", [
    ({"loader.items": 32, "loader.items_ready": 30}, 100 * 30 / 32),
    ({"loader.items": 8, "loader.items_ready": 8}, 100.0),
    ({"loader.items": 8}, 0.0),
    ({"native_loader.px_cropped": 5}, None),
    ({}, None),
])
def test_reader_on_a_synthetic_record(monkeypatch, counters, want):
    read = metric_reader(NAME)
    monkeypatch.setattr(program, "record",
                        lambda: {"spans": [], "counters": counters})
    got = read(Run("train", "bfloat16", {}))
    assert got == (pytest.approx(want) if want is not None else None)
    assert read(Run("serve", "bfloat16", {})) is None
    monkeypatch.setattr(program, "record", lambda: None)
    assert read(Run("train", "bfloat16", {})) is None
