"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, into ``build/torch_kernels/`` at the repository root. The library
name carries a hash of the source and flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import
time: the CPU tests import this module on hosts with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# -split-compile=0 optimizes a source's kernels in parallel on every CPU:
# nafblock_bwd.cu, the longest source, holds dozens of template instances,
# and its build is the longest part of the first use
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signatures of every entry point, per source file
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "nafblock_fwd": {
        "nafblk_a_mma_smem": (_L, [_I, _I]),
        "nafblk_b_mma_smem": (_L, [_I, _I, _I]),
        "nafblk_a_mma_blocks_per_sm": (_I, [_I, _I]),
        "nafblk_a_dw_blocks_per_sm": (_I, []),
        "nafblk_b_mma_blocks_per_sm": (_I, [_I, _I, _I]),
        "nafblk_a_tf32_smem": (_L, [_I, _I]),
        "nafblk_b_tf32_smem": (_L, [_I, _I, _I]),
        "nafblk_a_tf32_blocks_per_sm": (_I, [_I, _I]),
        "nafblk_a_tf32_dw_blocks_per_sm": (_I, []),
        "nafblk_b_tf32_blocks_per_sm": (_I, [_I, _I, _I]),
        "nafblk_a_workspace": (_L, [_I] * 8),
        "nafblk_a": (_I, [_P] * 11 + [_I] * 4 + [_F] + [_I] * 4 + [_P]),
        "nafblk_b_pixels": (_I, [_I, _I]),
        "nafblk_b": (_I, [_P] * 14 + [_I, _I, _I, _L, _F, _I, _I, _I, _P]),
    },
    "nafblock_bwd": {
        "nafblk_p1_pixels": (_I, [_I, _I]),
        "nafblk_p1_mma_smem": (_L, [_I, _I, _I]),
        "nafblk_smem_limit": (_L, []),
        "nafblk_p1_mma_blocks_per_sm": (_I, [_I, _I, _I]),
        "nafblk_p1_tf32_smem": (_L, [_I, _I, _I]),
        "nafblk_p1_tf32_blocks_per_sm": (_I, [_I, _I, _I]),
        "nafblk_p1_workspace": (_L, [_I, _I, _I, _L, _I, _I, _I]),
        "nafblk_p1": (_I, [_P] * 18 + [_I, _I, _I, _L, _F, _I, _I, _I, _P]),
        "nafblk_p2_mma_smem": (_L, [_I, _I]),
        "nafblk_p2_mma_blocks_per_sm": (_I, [_I, _I]),
        "nafblk_p2_dw_blocks_per_sm": (_I, []),
        "nafblk_p2_tf32_smem": (_L, [_I, _I]),
        "nafblk_p2_tf32_blocks_per_sm": (_I, [_I, _I]),
        "nafblk_p2_tf32_dw_blocks_per_sm": (_I, []),
        "nafblk_p2_pixels": (_I, [_I]),
        "nafblk_p2_workspace": (_L, [_I] * 8),
        "nafblk_p2": (_I, [_P] * 15 + [_I, _I, _I, _I, _F, _I, _I, _I, _I,
                                       _P]),
    },
    "layernorm": {
        "ln_bwd_blocks_per_sm": (_I, [_I, _I, _I]),
        "ln_fwd": (_I, [_P] * 6 + [_I, _I, _L, _F, _I, _I, _P]),
        "ln_bwd": (_I, [_P] * 7 + [_I, _I, _L, _I, _I, _I, _P]),
    },
    "pool": {
        "relu_pool_fwd": (_I, [_P, _P, _L] + [_I] * 9 + [_P]),
        "relu_pool_fwd_blocks_per_sm": (_I, [_I] * 4),
        "pool_bwd": (_I, [_P, _P, _P, _L, _I, _I, _I, _I, _P]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "lowlight_image_enhancement_tpu_torch are built at first use")
    return found


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, every ``csrc``
    header and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:12]}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=None) -> Dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns each source's
    compiler output (register and shared-memory use per kernel)."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs = {}
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, lib)
        logs[name] = log
    return logs


def current_stream(x) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``x``'s device:
    every kernel of the port is enqueued there."""
    import torch

    return torch.cuda.current_stream(x.device).cuda_stream


def launch(x, fn, *args) -> int:
    """``fn(*args, stream)`` with ``x``'s device current and ``stream``
    PyTorch's current stream there; returns the entry point's CUDA error
    code. The device guard is taken only when ``x`` lies on another device
    than the current one."""
    import torch

    if x.device.index == torch.cuda.current_device():
        return fn(*args, current_stream(x))
    with torch.cuda.device(x.device):
        return fn(*args, current_stream(x))


def load(name: str = "nafblock_fwd") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _LIBS[name] = lib
    return _LIBS[name]
