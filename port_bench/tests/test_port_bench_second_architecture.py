"""A model other than NAFNet goes into the benchmark by files alone.

A temporary checkout gets ``port_bench/`` copied unchanged and, beside
what it had, the files and entries that a new model's configuration
brings: a small NAFNet ``Baseline`` configuration whose ``reference`` is
``port_bench/tests/reference_baseline.py``, a serve and a train traffic
mix, a limits file for each cell, and ``BENCHMARK.json`` entries. Both
cells then run on the CPU through ``run_cell``, from that checkout and
with its copy of the harness, in one subprocess: sound, each reads
``correct: true`` and its MFU; with every Baseline block of the program
returning its input (the block's work left out where it is produced),
each reads ``correct: false``. No file the copy of the harness had is
changed."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CONFIG = "baseline_w8"
SEED = 2 ** 33 + 77
CELLS = {
    f"{CONFIG}.serve_small": ("newbp_w32.serve_burst8", {
        "kind": "serve", "images_per_call": 3, "height": 43, "width": 64,
        "pool": 5, "warmup_calls": 1, "sample_calls": 2, "traced_calls": 2,
        "server": {"bucket_step": 64, "min_bucket": 64, "max_bucket": 1024,
                   "max_batch": 8, "tile_overlap": 0.5}}),
    f"{CONFIG}.train_small": ("newbp_w32.train_sid384", {
        "kind": "train", "batch": 2, "patch": 32, "samples_per_pair": 4,
        "warmup_steps": 1, "traced_steps": 2, "ref_chunk": 2,
        "data": {"frames": 1, "height": 96, "width": 128, "ratios": [250]}}),
}
MFU = {"serve": "serve_mfu", "train": "train_mfu"}

# run in the checkout: the sound run traced, the faulted one not
SCRIPT = """
import contextlib, json, sys
from pathlib import Path
from unittest import mock

import port_bench
from lowlight_image_enhancement_tpu_torch.models import baseline
from port_bench.harness.spec import load_cell
from port_bench.run import result_line, run_cell

root = Path.cwd().resolve()
assert Path(port_bench.__file__).resolve().parent.parent == root
seed = int(sys.argv[1])
out = {"harness": str(Path(port_bench.__file__).resolve())}
for name in sys.argv[2:]:
    for fault in (False, True):
        cell = load_cell(name, root)
        with mock.patch.object(baseline.BaselineBlock, "forward",
                               lambda self, x: x) if fault else \\
                contextlib.nullcontext():
            run, attempted, failed, readings = run_cell(
                cell, seed, 1.0, not fault, "cpu")
        out[f"{name}:{'fault' if fault else 'sound'}"] = result_line(
            cell, run, attempted, failed, not fault, readings, cell.limits,
            "cpu")
print(json.dumps(out))
"""


def add_files(root: Path) -> None:
    """What a configuration of a new model adds: files and entries."""
    bench_dir = root / "port_bench"
    cfg = json.loads((bench_dir / "configs" / "newbp_w32.json").read_text())
    hybrid = dict(cfg["train"]["hybrid_opt"], use_perc=False)
    config = {
        "name": CONFIG,
        "reference": "port_bench/tests/reference_baseline.py",
        "dtype": "bfloat16",
        "network_g": {"type": "Baseline", "img_channel": 3, "width": 8,
                      "enc_blk_nums": [1, 1], "middle_blk_num": 1,
                      "dec_blk_nums": [1, 1], "dw_expand": 1,
                      "ffn_expand": 2},
        "train": dict(cfg["train"], hybrid_opt=hybrid),
        "reduced": [],
        "assumed": {"residual_scale": 0.1},
    }
    (bench_dir / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": CONFIG, "source": "https://arxiv.org/abs/2204.04676",
        "file": f"port_bench/configs/{CONFIG}.json", "reduced": [],
        "why": "NAFNet's Baseline, narrowed for a CPU test"})
    for name, (like, traffic) in CELLS.items():
        mix = name.split(".", 1)[1]
        (bench_dir / "traffic" / f"{mix}.json").write_text(
            json.dumps(traffic))
        shutil.copy(bench_dir / "limits" / f"{like}.json",
                    bench_dir / "limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": CONFIG,
                                   "traffic": mix, "chips": 1,
                                   "why": "a second architecture"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()) and \
                    not m["name"].startswith("nafblock_"):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def tree(path: Path) -> dict:
    return {p.relative_to(path): p.read_bytes() for p in sorted(
        path.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    add_files(root)
    env = dict(os.environ, PYTHONPATH=str(ROOT), USE_FLAX="0")
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(SEED), *CELLS], cwd=root,
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return root, json.loads(out.stdout.strip().splitlines()[-1])


def test_the_runs_used_the_checkouts_unchanged_harness(checkout):
    root, lines = checkout
    assert lines["harness"] == str(root.resolve() / "port_bench" /
                                   "__init__.py")
    had = tree(ROOT / "port_bench")
    now = tree(root / "port_bench")
    assert all(now[p] == b for p, b in had.items())
    assert sorted(set(now) - set(had)) == sorted(
        [Path("configs") / f"{CONFIG}.json"]
        + [Path("traffic") / f"{c.split('.', 1)[1]}.json" for c in CELLS]
        + [Path("limits") / f"{c}.json" for c in CELLS])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct_and_reads_its_mfu(checkout, cell):
    line = checkout[1][f"{cell}:sound"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    kind = CELLS[cell][1]["kind"]
    assert line["metrics"][MFU[kind]]["value"] > 0
    assert not any(m.startswith("nafblock_") for m in line["metrics"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_block_that_returns_its_input_is_not_correct(checkout, cell):
    line = checkout[1][f"{cell}:fault"]
    assert line["attempted"] > 0
    assert line["correct"] is False, line["checks"]
