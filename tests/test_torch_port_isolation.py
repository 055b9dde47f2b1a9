"""The PyTorch port stands alone: neither the port package nor
``chip_smoke.py`` loads ``jax`` or anything of the JAX package, and the
kernels are built for Hopper at first use (never at import)."""

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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
             or m == "lowlight_image_enhancement_tpu"
             or m.startswith("lowlight_image_enhancement_tpu."))
print(json.dumps({"bad": bad, "n": len(sys.modules)}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_nvcc_command_targets_sm90a(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    cmd = _build.nvcc_command("nafblock_fwd", tmp_path / "x.so")
    assert cmd[0] == str(nvcc)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/nafblock_fwd.cu")


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_library_name_tracks_source_and_flags():
    lib = _build.library_path("nafblock_fwd")
    assert lib.parent == _build.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "torch_kernels")
    assert lib.name.startswith("libnafblock_fwd.") and lib.suffix == ".so"
    assert set(_build.SIGNATURES) == {
        p.stem for p in _build.CSRC.glob("*.cu")}
