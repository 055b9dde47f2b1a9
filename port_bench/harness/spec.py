"""The benchmark's data: cells, configurations, traffic mixes, limits and
per-layer metric readers, all found by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
configuration's file is the ``file`` its ``configs`` entry gives; the
traffic mix is ``port_bench/traffic/<traffic>.json``; the limits of the
cell's correctness check are ``port_bench/limits/<workload>.json``; a
per-layer metric is read by ``port_bench/metrics/<metric>.py``'s
``read(run)``. Adding a cell, a mix, a metric or a model adds files and
entries and edits none.

A configuration's file names its plain reference: ``"reference"`` is the
path, from the checkout's root, of a module that knows the network's
architecture, so that nothing else in the harness does. It imports
nothing of the measured program and gives:

- ``param_shapes(network_g) -> {name: shape}``: the port network's
  persistent ``state_dict`` keys, in the order the seeded weights are
  drawn (``harness/weights.py:make_params``);
- ``forward(x, params, network_g, quant=None) -> y``: the network on fp32
  NCHW ``x``, plain fp32, with ``quant`` the control's rounding
  (``reference/ops.py``);
- ``in_channels(network_g) -> int``;
- ``init(name, shape, u) -> Tensor | None`` (optional): a leaf's seeded
  value from its uniform draw ``u`` where the default rule does not know
  the leaf, None to keep the default;
- ``counted`` (optional): ``{class name: record(args) -> tuple}``, the
  port modules whose traced calls the hooks keep, and what of each call
  (``harness/record.py:Hooks``);
- ``small(network_g) -> network_g`` (optional): a copy at a size that a
  CPU test run holds (``port_bench/tests/conftest.py``).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
MANIFEST = "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    reference: ModuleType
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def reports(metric: Dict[str, Any], cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (no ``workloads`` key: every
    cell)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    manifest = load_json(root / MANIFEST)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {MANIFEST}")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=config, reference=reference_module(root, config["reference"]),
        traffic_name=w["traffic"],
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(limits_path)["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, name)])


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_module(root: Path, path: str) -> ModuleType:
    """The plain reference module at ``path`` under ``root``."""
    stem = Path(path).with_suffix("").as_posix()
    return load_module(root / path, "port_bench_reference_" + "".join(
        ch if ch.isalnum() else "_" for ch in stem))


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``read(run)`` of ``port_bench/metrics/<name>.py``."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"port_bench_metric_{name.replace('.', '_')}").read
