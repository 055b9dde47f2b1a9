"""The per-layer metrics that read the program's own spans and counters
(``port_bench/harness/program.py``): each reader on a synthetic record,
None where nothing was recorded or the package has no recorder, and a
small traced CPU run of both serving cells and a training cell in which
every such metric the cell lists reads a number."""

import json
from collections import namedtuple
from pathlib import Path

import pytest

from port_bench.harness import program
from port_bench.harness.record import Run
from port_bench.harness.spec import metric_reader

BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())
PROGRAM = {m["name"]: m for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")}
Span = namedtuple("Span", "name parent unit thread t0 t1")


def spans(*rows):
    """``(name, unit, seconds)`` rows as records laid end to end."""
    out, t = [], 0.0
    for name, unit, dur in rows:
        out.append(Span(name, None, unit, 1, t, t + dur))
        t += dur
    return out


SERVE = {"spans": spans(
    ("serving.pad", 1, 0.010), ("serving.h2d", 1, 0.004),
    ("serving.d2h", 1, 0.030), ("serving.gather", 1, 0.002),
    ("serving.predict", 1, 0.100),
    ("validation.tiles", 2, 0.006), ("serving.h2d", 2, 0.010),
    ("validation.blend", 2, 0.040), ("validation.blend", 2, 0.020),
    ("serving.d2h", 2, 0.020), ("serving.predict", 2, 0.200)),
    "counters": {"serving.px_in": 97, "serving.px_run": 100}}
TRAIN = {"spans": spans(
    ("native_loader.decode", 1, 0.050), ("native_loader.decode", 1, 0.030),
    ("trainer.fetch", 1, 0.090), ("train_step.forward", 1, 0.100),
    ("train_step.backward", 1, 0.040), ("train_step.optimizer", 1, 0.150),
    ("trainer.step", 1, 0.300), ("native_loader.decode", 2, 0.040),
    ("trainer.fetch", 2, 0.050), ("train_step.forward", 2, 0.120),
    ("train_step.backward", 2, 0.060), ("train_step.optimizer", 2, 0.130),
    ("trainer.step", 2, 0.320)),
    "counters": {"native_loader.px_cropped": 3 * 384 * 384,
                 "native_loader.px_inflated": 3 * 448 * 4256,
                 "loader.items": 8, "loader.items_ready": 6}}
EXPECTED = {
    "serve_stage_ms": (SERVE, "serve", (10 + 4 + 6 + 10) / 2),
    "serve_readback_ms": (SERVE, "serve", (30 + 2 + 20) / 2),
    "serve_blend_ms": (SERVE, "serve", (40 + 20) / 2),
    "serve_useful_px": (SERVE, "serve", 97.0),
    "data_decode_ms.train": (TRAIN, "train", (50 + 30 + 40) / 2),
    "data_useful_decode.train": (TRAIN, "train",
                                 100 * 384 * 384 / (448 * 4256)),
    "data_ready_share.train": (TRAIN, "train", 100 * 6 / 8),
    "step_forward_ms.train": (TRAIN, "train", (100 + 120) / 2),
    "step_backward_ms.train": (TRAIN, "train", (40 + 60) / 2),
    "step_optimizer_ms.train": (TRAIN, "train", (150 + 130) / 2),
}


def test_every_program_metric_has_a_case_here():
    assert set(PROGRAM) == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_record(monkeypatch, name):
    rec, kind, value = EXPECTED[name]
    read = metric_reader(name)
    monkeypatch.setattr(program, "record", lambda: rec)
    assert read(Run(kind, "bfloat16", {})) == pytest.approx(value)
    other = "train" if kind == "serve" else "serve"
    assert read(Run(other, "bfloat16", {})) is None
    monkeypatch.setattr(program, "record", lambda: {
        "spans": [], "counters": {}})
    assert read(Run(kind, "bfloat16", {})) is None
    monkeypatch.setattr(program, "record", lambda: None)
    assert read(Run(kind, "bfloat16", {})) is None


def test_a_package_without_the_recorder_reads_none(monkeypatch):
    from lowlight_image_enhancement_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "record")
    assert program.record() is None
    assert program.ms_per_unit(Run("serve", "bfloat16", {}),
                               ("serving.pad",)) is None
    assert program.counter_share("serving.px_in", "serving.px_run") is None


@pytest.mark.parametrize("cell", ["newbp_w32.serve_burst8",
                                  "newbp_w64.serve_fullframe",
                                  "newbp_w32.train_sid384"])
def test_a_small_traced_run_reads_every_program_metric_it_lists(small_cell,
                                                                 cell):
    from lowlight_image_enhancement_tpu_torch.utils import profiling
    from port_bench.run import result_line, run_cell

    c = small_cell(cell)
    profiling.reset()
    run, attempted, failed, readings = run_cell(c, 2718281828, 1.0, True,
                                                "cpu")
    line = result_line(c, run, attempted, failed, True, readings, c.limits,
                       "cpu")
    listed = [m["name"] for m in c.per_layer if m["name"] in PROGRAM]
    assert listed and line["correct"], line["checks"]
    for name in listed:
        assert name in line["metrics"], name
        assert line["metrics"][name]["value"] > 0, name
    rec = profiling.record()
    top = program.UNIT_SPAN[run.kind]
    assert sum(s.name == top for s in rec["spans"]) == len(run.traced)
    profiling.reset()
