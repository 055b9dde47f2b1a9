"""The PyTorch port stands alone: neither the port package (its
``tools/`` subpackage, multi-worker loader and backend probe included)
nor ``chip_smoke.py`` loads ``jax``, ``grain`` or anything of the JAX
package, and the kernels are built for Hopper at first use (never at
import)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from lowlight_image_enhancement_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import lowlight_image_enhancement_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "grain")
             or m == "lowlight_image_enhancement_tpu"
             or m.startswith("lowlight_image_enhancement_tpu."))
print(json.dumps({"bad": bad, "n": len(sys.modules), "port": sorted(
    m for m in sys.modules if m.startswith(port.__name__ + "."))}))
"""

# modules of the tools slice that the walk must reach
TOOLS_SLICE = ["tools." + name for name in (
    "bench_input_pipeline", "common", "convert_sid_raw_to_png",
    "create_sid_pack", "debug_dataset", "debug_losses", "debug_overfit",
    "evaluate", "make_niqe_params", "profile_step_families",
    "profile_train", "train_pipeline_e2e")] + [
    "data.grain_pipeline", "utils.backend_probe"]


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    port = {m.split(".", 1)[1] for m in out["port"]}
    assert set(TOOLS_SLICE) <= port, sorted(set(TOOLS_SLICE) - port)


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


SOURCES = ["nafblock_fwd", "nafblock_bwd", "layernorm", "pool"]


@pytest.mark.parametrize("name", SOURCES)
def test_nvcc_command_targets_sm90a(tmp_path, monkeypatch, name):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    cmd = _build.nvcc_command(name, tmp_path / "x.so")
    assert cmd[0] == str(nvcc)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith(f"csrc/{name}.cu")


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


@pytest.mark.parametrize("name", SOURCES)
def test_library_name_tracks_source_and_flags(name, monkeypatch):
    lib = _build.library_path(name)
    assert lib.parent == _build.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "torch_kernels")
    assert lib.name.startswith(f"lib{name}.") and lib.suffix == ".so"
    assert set(_build.SIGNATURES) == set(SOURCES) == {
        p.stem for p in _build.CSRC.glob("*.cu")}
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-g"])
    assert _build.library_path(name) != lib


def test_build_starts_one_nvcc_per_missing_source(tmp_path, monkeypatch):
    """``build`` compiles every source that has no current library, all
    started together, and moves each result to its hashed name."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "k")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    started = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **_kw):
            started.append(cmd[-1])
            self.out = Path(cmd[cmd.index("-o") + 1])

        def communicate(self):
            assert len(started) == len(SOURCES)     # all started first
            self.out.write_bytes(b"")
            return "ptxas info", None

    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    logs = _build.build()
    assert sorted(logs) == sorted(SOURCES)
    assert sorted(Path(s).stem for s in started) == sorted(SOURCES)
    assert all(_build.library_path(n).exists() for n in SOURCES)
    assert _build.build() == {}                     # nothing left to build
