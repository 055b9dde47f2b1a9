"""Bridge from the JAX NAFNet parameter tree to this port's ``state_dict``.

:func:`params_from_jax` takes the Flax tree of
``lowlight_image_enhancement_tpu.models.nafnet.NAFNet`` as numpy arrays
(unrolled ``enc{s}_blk{b}`` or scanned ``enc{s}_blks/scan/blk`` layout)
and returns a ``state_dict`` for :class:`...models.nafnet.NAFNet`:

- conv kernels HWIO -> OIHW (depthwise ``[3,3,1,C]`` -> ``[C,1,3,3]``);
- ``enc{s}_blk{b}`` -> ``encoders.{s}.{b}``, ``dec{s}_blk{b}`` ->
  ``decoders.{s}.{b}``, ``mid_blk{b}`` -> ``middle_blks.{b}``,
  ``down{s}`` -> ``downs.{s}``, ``up{s}`` -> ``ups.{s}.0``,
  ``sca_conv`` -> ``sca.1``, ``beta``/``gamma`` ``[C]`` -> ``[1,C,1,1]``.

:func:`vgg_params_from_jax` does the same for the Flax VGG19 trunk of
the perceptual loss (``conv{s}_{i}`` HWIO -> the port's
:class:`...models.vgg.VGG19Features` ``state_dict``).

An unknown or missing key raises ``KeyError``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch.models.vgg import conv_names

_BLOCK_CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5")
_STAGE = {"enc": "encoders", "dec": "decoders"}


def unstack_block_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Scanned layout (``{stage}_blks/scan/blk``, stacked leading axis) ->
    unrolled ``{stage}_blk{i}`` (port of the JAX ``unstack_block_params``)."""
    out: Dict[str, Any] = {}
    for key, sub in params.items():
        if not key.endswith("_blks"):
            out[key] = sub
            continue
        stage = key[: -len("_blks")]
        stacked = sub["scan"]["blk"]
        num = _first_leaf(stacked).shape[0]
        for i in range(num):
            out[f"{stage}_blk{i}"] = _map_leaves(lambda a, i=i: a[i], stacked)
    return out


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _check_keys(sub, where: str, names) -> None:
    if not isinstance(sub, Mapping) or set(sub) != set(names):
        got = sorted(sub) if isinstance(sub, Mapping) else type(sub).__name__
        raise KeyError(f"{where}: expected keys {sorted(names)}, got {got}")


def _leaves(sub: Mapping[str, Any], where: str, names) -> list:
    _check_keys(sub, where, names)
    return [np.array(sub[k], np.float32) for k in names]


def _oihw(kernel: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))


def _conv(sub, where: str, bias: bool = True) -> Dict[str, torch.Tensor]:
    if not bias:
        (k,) = _leaves(sub, where, ("kernel",))
        return {"weight": _oihw(k)}
    k, b = _leaves(sub, where, ("kernel", "bias"))
    return {"weight": _oihw(k), "bias": torch.from_numpy(b)}


def block_state_from_jax(sub: Mapping[str, Any],
                         where: str = "block") -> Dict[str, torch.Tensor]:
    """One Flax NAFBlock subtree -> the port's NAFBlock ``state_dict``."""
    _check_keys(sub, where, (*_BLOCK_CONVS, "sca_conv", "norm1", "norm2",
                             "beta", "gamma"))
    sd: Dict[str, torch.Tensor] = {}
    for name in _BLOCK_CONVS:
        for k, v in _conv(sub[name], f"{where}/{name}").items():
            sd[f"{name}.{k}"] = v
    for k, v in _conv(sub["sca_conv"], f"{where}/sca_conv").items():
        sd[f"sca.1.{k}"] = v
    for name in ("norm1", "norm2"):
        w, b = _leaves(sub[name], f"{where}/{name}", ("weight", "bias"))
        sd[f"{name}.weight"] = torch.from_numpy(w)
        sd[f"{name}.bias"] = torch.from_numpy(b)
    for name in ("beta", "gamma"):
        sd[name] = torch.from_numpy(
            np.array(sub[name], np.float32).reshape(1, -1, 1, 1))
    return sd


def params_from_jax(tree: Mapping[str, Any],
                    model: torch.nn.Module = None) -> Dict[str, torch.Tensor]:
    """JAX NAFNet params (numpy leaves) -> the port's NAFNet ``state_dict``.

    With ``model``, the result must hold exactly ``model``'s parameter
    names and shapes."""
    sd: Dict[str, torch.Tensor] = {}
    for key in ("intro", "ending"):
        if key not in tree:
            raise KeyError(f"missing NAFNet parameter group {key!r}")
    for key, sub in unstack_block_params(tree).items():
        if key in ("intro", "ending"):
            prefix, conv = key, _conv(sub, key)
        elif m := re.fullmatch(r"down(\d+)", key):
            prefix, conv = f"downs.{m.group(1)}", _conv(sub, key)
        elif m := re.fullmatch(r"up(\d+)", key):
            prefix, conv = f"ups.{m.group(1)}.0", _conv(sub, key, bias=False)
        elif m := re.fullmatch(r"(enc|dec)(\d+)_blk(\d+)", key):
            stage, s, b = m.groups()
            prefix = f"{_STAGE[stage]}.{s}.{b}"
            conv = block_state_from_jax(sub, key)
        elif m := re.fullmatch(r"mid_blk(\d+)", key):
            prefix, conv = f"middle_blks.{m.group(1)}", block_state_from_jax(
                sub, key)
        else:
            raise KeyError(f"unknown NAFNet parameter group {key!r}")
        for k, v in conv.items():
            sd[f"{prefix}.{k}"] = v
    if model is not None:
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if want != got:
            raise KeyError(
                f"parameters do not fit the model: missing "
                f"{sorted(set(want) - set(got))}, unknown "
                f"{sorted(set(got) - set(want))}, shape mismatch "
                f"{sorted(k for k in set(want) & set(got) if want[k] != got[k])}")
    return sd


def vgg_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``VGG19Features`` params (``conv{s}_{i}`` -> ``kernel`` HWIO,
    ``bias``; numpy leaves) -> the port's ``VGG19Features`` ``state_dict``
    (OIHW). Exactly the 16 convs of VGG19 up to relu5_4 are required."""
    names = [n for n, _, _ in conv_names()]
    if set(tree) != set(names):
        raise KeyError(f"VGG19 params: missing {sorted(set(names) - set(tree))}"
                       f", unknown {sorted(set(tree) - set(names))}")
    sd: Dict[str, torch.Tensor] = {}
    for name in names:
        for k, v in _conv(tree[name], name).items():
            sd[f"{name}.{k}"] = v
    return sd
