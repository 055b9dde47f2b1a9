"""YAML experiment configs: the port's copy of ``parse`` from
``lowlight_image_enhancement_tpu/training/config.py`` (reference
``basicsr/utils/options.py``).

``parse(opt_path, is_train)`` loads a YAML into a nested dict and applies
``${VAR}`` env-var expansion (plus ``SID_ROOT`` auto-detection), the
phase split of ``datasets:`` keys, ``scale`` propagation, the derived
experiment/result dirs and the debug-name frequency overrides. A config
that names ``${DEBUG_SID_ROOT}`` while the variable is unset gets the
synthetic debug data set, generated once (the port's ``make_debug_sid``)
under the temporary directory, as the JAX version does.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

_ENV_RE = re.compile(r"\$\{(\w+)\}")

_SID_MARKERS = ("SID_assets", "SID_lmdb", "SID_raw", "SID_experiments",
                "SID_pack")


def find_sid_root(start: Optional[str] = None) -> Optional[str]:
    """Env ``SID_ROOT``/``LOWLIGHT_ROOT``, else walk up from ``start`` for a
    directory holding >= 2 SID marker subdirectories."""
    for var in ("SID_ROOT", "LOWLIGHT_ROOT"):
        val = os.environ.get(var)
        if val and os.path.isdir(val):
            return val
    cur = Path(start or os.getcwd()).resolve()
    for cand in (cur, *cur.parents):
        if sum((cand / m).is_dir() for m in _SID_MARKERS) >= 2:
            return str(cand)
    return None


def _default_debug_sid_root() -> str:
    """Self-provision the hermetic debug fixture set when a config names
    ``${DEBUG_SID_ROOT}`` and the variable is unset (JAX
    ``_default_debug_sid_root``): generated once under the temporary
    directory, into a private directory that is then renamed into place,
    so two concurrent parses never see half-written packs. Sets
    ``DEBUG_SID_ROOT`` for the rest of the process."""
    uid = getattr(os, "getuid", lambda: "u")()
    root = os.path.join(tempfile.gettempdir(), f"llie_torch_debug_sid_{uid}")
    manifest = os.path.join(root, "manifest_sid_debug.json")
    if not os.path.exists(manifest):
        from lowlight_image_enhancement_tpu_torch.data.debug_fixtures import (
            make_debug_sid,
        )

        tmp = f"{root}.build{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            make_debug_sid(tmp)
            try:
                os.rename(tmp, root)
            except OSError:
                # lost the race, or a partial root from an interrupted
                # build: keep a root with a manifest, else replace it
                if not os.path.exists(manifest):
                    shutil.rmtree(root, ignore_errors=True)
                    try:
                        os.rename(tmp, root)
                    except OSError:
                        if not os.path.exists(manifest):
                            raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        logging.getLogger(__name__).info(
            "DEBUG_SID_ROOT unset: generated synthetic debug fixtures at %s",
            root)
    os.environ["DEBUG_SID_ROOT"] = root
    return root


def _expand_value(val: Any, env: Dict[str, str]) -> Any:
    if isinstance(val, str):
        def sub(m):
            name = m.group(1)
            if name in env:
                return env[name]
            if name in os.environ:
                return os.environ[name]
            if name == "DEBUG_SID_ROOT":
                return _default_debug_sid_root()
            return m.group(0)

        return _ENV_RE.sub(sub, val)
    if isinstance(val, dict):
        return {k: _expand_value(v, env) for k, v in val.items()}
    if isinstance(val, list):
        return [_expand_value(v, env) for v in val]
    return val


def parse(opt_path: str, is_train: bool = True,
          root_dir: Optional[str] = None) -> Dict[str, Any]:
    with open(opt_path) as f:
        opt = yaml.safe_load(f)

    env: Dict[str, str] = {}
    sid_root = find_sid_root()
    if sid_root:
        env["SID_ROOT"] = sid_root
    opt = _expand_value(opt, env)

    opt["is_train"] = is_train
    opt.setdefault("dist", False)
    opt.setdefault("rank", 0)
    opt.setdefault("world_size", 1)
    opt.setdefault("manual_seed", 0)
    scale = opt.get("scale", 1)
    opt["scale"] = scale

    for phase_key, ds in list((opt.get("datasets") or {}).items()):
        if isinstance(ds, dict):
            ds["phase"] = ds.get("phase", phase_key.split("_")[0])
            ds["scale"] = scale

    root = Path(root_dir or os.getcwd())
    name = opt.get("name", "experiment")
    path_opt = opt.setdefault("path", {})
    if is_train:
        exp_root = root / "experiments" / name
        path_opt["experiments_root"] = str(exp_root)
        path_opt["models"] = str(exp_root / "models")
        path_opt["training_states"] = str(exp_root / "training_states")
        path_opt["log"] = str(exp_root)
        path_opt["visualization"] = str(exp_root / "visualization")
        if "debug" in name:
            opt.setdefault("val", {})["val_freq"] = 8
            logger_opt = opt.setdefault("logger", {})
            logger_opt["print_freq"] = 1
            logger_opt["save_checkpoint_freq"] = 8
    else:
        results_root = root / "results" / name
        path_opt["results_root"] = str(results_root)
        path_opt["log"] = str(results_root)
        path_opt["visualization"] = str(results_root / "visualization")
    return opt


def dict2str(opt: Dict[str, Any], indent: int = 1) -> str:
    """Pretty-print a nested config (reference ``dict2str``)."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent * 2) + f"{k}:\n" + dict2str(v, indent + 1)
        else:
            msg += " " * (indent * 2) + f"{k}: {v}\n"
    return msg
