"""Checkpoint save, restore and auto-resume (``torch.save``).

Counterpart of ``lowlight_image_enhancement_tpu/training/checkpoint.py``
(reference ``base_model.py:194-333``, ``train.py:182-204``), with the same
semantics and PyTorch files in place of orbax directories:

- :func:`save_training_state` writes ``root/<step:08d>.pth``: the network
  parameters, ``log_sigma``, the step and ``ChainOptimizer``'s state
  (``count``, which drives the schedule and the bias corrections,
  ``mini_step``, ``mu``, ``nu`` and the accumulation buffers);
- :func:`save_network` writes the params-only ``net_g_<step:08d>.pth``
  and ``net_g_latest.pth``: plain ``state_dict`` files, which
  ``demo.load_weights`` reads;
- :func:`latest_training_state`, :func:`restore_training_state`,
  :func:`auto_resume` resume from the highest step; :func:`restore_network`
  and :func:`merge_params` load weights strictly or not.

A restore copies into the tensors of the state it is given, so the
optimizer stays bound to the network's parameters.

Under a ``torch.distributed`` world every rank calls
:func:`save_training_state` (with ZeRO-1 the moments are gathered from
every rank's slices, so the file is the one a replicated run writes) and
rank 0 writes it; a restore cuts the moments again into this rank's
slices.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Dict, Optional

import torch
from torch import nn

from lowlight_image_enhancement_tpu_torch.parallel.multihost import host_info
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    STATE_KEYS,
    TrainState,
)


def _optimizer_state(opt) -> dict:
    lists = {k: (None if v is None else [t.detach().cpu() for t in v])
             for k, v in opt.full_state().items()}
    return {"count": int(opt.count), "mini_step": int(opt.mini_step),
            **lists}


def training_state_path(root: str, step: int) -> str:
    """``root/<step:08d>.pth``: where step ``step``'s train state lies."""
    return os.path.join(os.path.abspath(root), f"{int(step):08d}.pth")


def save_training_state(root: str, state: TrainState) -> str:
    """Write the whole train state to :func:`training_state_path` (on
    rank 0; every rank of a world calls it)."""
    path = training_state_path(root, state.step)
    optimizer = _optimizer_state(state.optimizer)
    if not host_info()[2]:
        return path
    os.makedirs(root, exist_ok=True)
    torch.save({
        "step": int(state.step),
        "params": {k: v.detach().cpu()
                   for k, v in state.model.state_dict().items()},
        "log_sigma": {k: v.detach().cpu()
                      for k, v in state.log_sigma.items()},
        "optimizer": optimizer,
    }, path)
    return path


def save_network(root: str, state: TrainState, latest: bool = True) -> str:
    """Write ``root/net_g_<step:08d>.pth`` (and ``net_g_latest.pth``): the
    network's ``state_dict``."""
    os.makedirs(root, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    path = os.path.join(os.path.abspath(root),
                        f"net_g_{int(state.step):08d}.pth")
    torch.save(sd, path)
    if latest:
        torch.save(sd, os.path.join(os.path.abspath(root), "net_g_latest.pth"))
    return path


def latest_training_state(root: str) -> Optional[str]:
    """The ``<step>.pth`` of the highest step under ``root``, or None."""
    if not os.path.isdir(root):
        return None
    best, best_step = None, -1
    for entry in os.listdir(root):
        m = re.fullmatch(r"(\d+)\.pth", entry)
        if m and int(m.group(1)) > best_step:
            best, best_step = entry, int(m.group(1))
    return os.path.join(os.path.abspath(root), best) if best else None


def _check_fit(dst, src, what: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"{what}: {len(src)} saved tensors, the state has "
                         f"{len(dst)}")
    for d, s in zip(dst, src):
        if d.shape != s.shape:
            raise ValueError(f"{what}: saved {tuple(s.shape)}, the state has "
                             f"{tuple(d.shape)}")


@torch.no_grad()
def _copy_into(dst, src, what: str) -> None:
    _check_fit(dst, src, what)
    for d, s in zip(dst, src):
        d.copy_(s)


def restore_training_state(path: str, state: TrainState) -> TrainState:
    """Restore a state written by :func:`save_training_state` into
    ``state`` (its tensors are overwritten in place) and return it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["params"], strict=True)
    _copy_into(list(state.log_sigma.values()),
               [ckpt["log_sigma"][k] for k in state.log_sigma], "log_sigma")
    opt, saved = state.optimizer, ckpt["optimizer"]
    for k in STATE_KEYS:
        if (getattr(opt, k) is None) != (saved[k] is None):
            raise ValueError(f"optimizer state {k!r} does not match the "
                             "optimizer's configuration")
        if saved[k] is not None:
            # full-size moments (a ZeRO-1 rank keeps its slices of them)
            _check_fit(opt.params, saved[k], f"optimizer {k}")
    opt.load_state(saved)
    opt.count = int(saved["count"])
    opt.mini_step = int(saved["mini_step"])
    state.step = int(ckpt["step"])
    return state


def merge_params(template: Dict[str, torch.Tensor],
                 restored: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Non-strict merge of two state dicts: entries of ``restored`` whose
    name and shape exist in ``template`` replace them; the rest is skipped
    with a warning."""
    merged = dict(template)
    skipped = []
    for key, leaf in restored.items():
        if key not in template:
            skipped.append(("unexpected", key))
        elif tuple(template[key].shape) != tuple(leaf.shape):
            skipped.append(("shape-mismatch", key))
        else:
            merged[key] = leaf
    skipped += [("missing", k) for k in template if k not in restored]
    if skipped:
        warnings.warn(f"non-strict load skipped {len(skipped)} entries "
                      f"(first few: {skipped[:4]})", stacklevel=2)
    return merged


def restore_network(path: str, net: nn.Module, strict: bool = True
                    ) -> nn.Module:
    """Load a params-only checkpoint into ``net``. ``strict=False`` is the
    reference's tolerant ``load_network`` (``base_model.py:262-287``):
    matching names and shapes load, the rest keep ``net``'s values."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("params", sd)
    if not strict:
        sd = merge_params(net.state_dict(), sd)
    net.load_state_dict(sd, strict=True)
    return net


def auto_resume(root: str, state: TrainState) -> Optional[TrainState]:
    """Resume ``state`` from the latest state under ``root``, if any."""
    path = latest_training_state(root)
    if path is None:
        return None
    return restore_training_state(path, state)
