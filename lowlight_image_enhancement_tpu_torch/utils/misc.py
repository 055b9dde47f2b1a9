"""Misc utilities (reference ``basicsr/utils/misc.py:18-186``): the port's
copy of ``lowlight_image_enhancement_tpu/utils/misc.py``.

``set_random_seed``, ``get_time_str``, ``mkdir_and_rename`` (archive an
existing experiment dir with a timestamp suffix), ``make_exp_dirs``,
``scandir``, ``check_resume`` (rewrite pretrain paths to resume
checkpoints), ``sizeof_fmt``.
"""

from __future__ import annotations

import os
import random
import time
from typing import Any, Dict, Generator, Optional

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed python, numpy and torch (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str) -> None:
    """mkdir; if it exists, archive it as ``<path>_archived_<timestamp>``."""
    if os.path.exists(path):
        new_name = f"{path}_archived_{get_time_str()}"
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt: Dict[str, Any]) -> None:
    """Create the experiment directory tree from a parsed config."""
    path_opt = dict(opt.get("path", {}))
    if opt.get("is_train", True):
        root = path_opt.pop("experiments_root", None)
        if root:
            mkdir_and_rename(root)
    else:
        root = path_opt.pop("results_root", None)
        if root:
            mkdir_and_rename(root)
    for key, p in path_opt.items():
        if ("pretrain" in key or "resume" in key or not isinstance(p, str)
                or not p):
            continue
        os.makedirs(p, exist_ok=True)


def scandir(
    dir_path: str,
    suffix: Optional[str] = None,
    recursive: bool = False,
    full_path: bool = False,
) -> Generator[str, None, None]:
    """Scan a directory for files with an optional suffix filter."""
    root = dir_path

    def _scan(d):
        for entry in sorted(os.scandir(d), key=lambda e: e.path):
            if entry.name.startswith("."):
                continue
            if entry.is_file():
                rel = (entry.path if full_path
                       else os.path.relpath(entry.path, root))
                if suffix is None or rel.endswith(suffix):
                    yield rel
            elif recursive and entry.is_dir():
                yield from _scan(entry.path)

    yield from _scan(dir_path)


def check_resume(opt: Dict[str, Any], resume_iter: int) -> None:
    """When resuming, point pretrain paths at the resume-iter network
    checkpoints (reference ``check_resume``)."""
    if not opt.get("path", {}).get("resume_state"):
        return
    path_opt = opt["path"]
    models_dir = path_opt.get("models", "")
    for key in list(path_opt):
        if key.startswith("pretrain_network_"):
            name = key[len("pretrain_network_"):]
            path_opt[key] = os.path.join(
                models_dir, f"net_{name}_{resume_iter:08d}"
            )


def sizeof_fmt(size: float, suffix: str = "B") -> str:
    for unit in ("", "K", "M", "G", "T", "P", "E", "Z"):
        if abs(size) < 1024.0:
            return f"{size:3.1f} {unit}{suffix}"
        size /= 1024.0
    return f"{size:3.1f} Y{suffix}"
