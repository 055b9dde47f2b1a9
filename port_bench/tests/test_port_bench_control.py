"""The control, the plain reference computed in fp8 (every stored tensor
rounded to e4m3: the precision below the configurations' bf16) and put
in the program's place, must come out as not correct under each cell's
limits. On the CPU at a small size for the served cells; on the card at
each cell's own size (``-m card``), as ``port_bench/control.py`` reads
it to set the limits."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench.harness import serve, train
from port_bench.harness.spec import load_cell
from port_bench.run import judge

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SERVED = [c for c in CELLS if "serve" in c]


def judged_correct(readings, limits):
    """The harness's own judgement, as of a run with one unit attempted
    and none failed."""
    return judge(readings, limits, 1, 0)


def control(cell, seed, device):
    if cell.traffic["kind"] == "serve":
        return serve.control_readings(cell, seed, device)
    return train.control_readings(cell, seed, device)["control_fp8"]


def stand_ins(cell, seed, device):
    """The control and, in a training cell, each stand-in of a broken
    step, by name."""
    if cell.traffic["kind"] == "serve":
        return {"control_fp8": serve.control_readings(cell, seed, device)}
    return train.control_readings(cell, seed, device)


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3, 7 * 10 ** 9])
def test_served_control_is_not_correct_at_a_small_size(small_cell, name,
                                                       seed):
    cell = small_cell(name)
    assert not judged_correct(control(cell, seed, "cpu"), cell.limits)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cells_size(cuda, name):
    """The control, and each stand-in that the cell's limits file says
    its limits catch (``catches``), at the cell's own size."""
    cell = load_cell(name, ROOT)
    catches = json.loads((ROOT / "port_bench" / "limits"
                          / f"{name}.json").read_text())["catches"]
    for seed in (4100104729, 4100209458, 4100314187):
        readings = stand_ins(cell, seed, cuda)
        for who in catches:
            assert not judged_correct(readings[who], cell.limits), (who,
                                                                    seed)


@pytest.mark.card
def test_a_short_run_prints_the_contracts_line(cuda):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", SERVED[0],
         "--seed", "5", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("check out_gap")
