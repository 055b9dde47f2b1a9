"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "port_bench.run"]
    assert BENCH["paths"] == ["port_bench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E[
        "setup_s"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_what_the_contract_asks(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m, cell)]
    per = [m for m in BENCH["per_layer"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    bench = ROOT / "port_bench"
    assert (bench / "traffic" / f"{CELLS[cell]['traffic']}.json").is_file()
    assert (bench / "limits" / f"{cell}.json").is_file()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_moves_an_end_to_end_metric_of_each_cell(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["moves"] in E2E
    cells = m.get("workloads", list(CELLS))
    for cell in cells:
        assert cell in CELLS and reports(E2E[m["moves"]], cell)
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_every_metric_has_a_reader_and_every_config_a_cell():
    from port_bench.harness.spec import metric_reader

    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(metric_reader(m["name"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_load_cell_and_limits(cell):
    from port_bench.harness.spec import load_cell

    c = load_cell(cell, ROOT)
    assert c.traffic["kind"] in ("serve", "train")
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert c.config["reduced"] == [
        x for x in BENCH["configs"] if x["name"] == c.config_name][0][
            "reduced"]


def test_free_text_fields_fit_one_line_of_200():
    texts = list(BENCH["command"])
    texts += [c[k] for c in BENCH["configs"] for k in ("why", "source")]
    texts += [w["why"] for w in BENCH["workloads"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for c in BENCH["configs"]:
        assert c["source"].startswith("https://") and len(c["reduced"]) <= 16
