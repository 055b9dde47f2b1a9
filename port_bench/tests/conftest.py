"""Tests of the benchmark harness. Run from the repository root:

    python -m pytest port_bench/tests -q            # CPU: ~2 min
    python -m pytest port_bench/tests -q -m card    # on a machine with a card

Tests marked ``card`` need an NVIDIA card; the ``cuda`` fixture skips
them where there is none (decided when the test runs, never at import).
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: this test runs on the card")
    return "cuda"


def small(cell):
    """A copy of ``cell`` at a size a CPU test run holds: the network
    narrowed and shallowed by its reference's ``small``, the images and
    crops shrunk, the traffic's counts cut; everything else (kinds, server
    settings, limits) kept."""
    import copy
    import dataclasses

    reference = cell.reference
    cell = copy.deepcopy(dataclasses.replace(cell, reference=None))
    cell.reference = reference
    cell.config["network_g"] = reference.small(cell.config["network_g"])
    t = cell.traffic
    if t["kind"] == "serve":
        if t["height"] > t["server"]["max_bucket"]:
            t.update(height=150, width=200,
                     server=dict(t["server"], max_bucket=64, max_batch=4))
        else:
            t.update(height=43, width=64, images_per_call=3, pool=5)
        t.update(warmup_calls=1, traced_calls=2, sample_calls=2)
    else:
        t["data"].update(height=96, width=128)
        if "sub_image" in t["data"]:
            t["data"].update(sub_image=64, sub_step=48, sub_images=4)
        t.update(patch=32, batch=min(t["batch"], 4), warmup_steps=1,
                 traced_steps=2, ref_chunk=2)
    return cell


@pytest.fixture
def small_cell():
    from port_bench.harness.spec import load_cell

    root = Path(__file__).resolve().parents[2]
    return lambda name: small(load_cell(name, root))
