"""No file of the benchmark imports JAX, its libraries or the JAX
package; the reference imports nothing of the measured program either.
Module names are compared by their whole top-level name: the port's name
begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lowlight_image_enhancement_tpu"}
PORT = "lowlight_image_enhancement_tpu_torch"


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert PORT not in names
    assert names <= {"__future__", "math", "typing", "torch", "port_bench"}


def test_the_walk_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text(f"import {PORT}.serving\nfrom jax import numpy\n")
    assert list(top_level_imports(f)) == [PORT, "jax"]
    assert PORT not in FORBIDDEN


def test_importing_the_harness_loads_no_jax():
    code = ("import sys, port_bench.run, port_bench.control, "
            "port_bench.harness.serve, port_bench.harness.train; "
            "from port_bench.run import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the run exits non-zero and prints nothing on
    standard output; so does a checkout that holds only the benchmark."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cmd = [sys.executable, "-m", "port_bench.run", "--workload",
           "newbp_w32.serve_burst8", "--seed", "1", "--seconds", "1"]
    out = subprocess.run(cmd, cwd=BENCH.parent, capture_output=True,
                         text=True)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench")
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
