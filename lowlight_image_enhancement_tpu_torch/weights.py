"""Bridge from the JAX parameter trees to this port's ``state_dict``s.

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

:func:`baseline_params_from_jax` and :func:`nafssr_params_from_jax` do
it for the Flax ``Baseline`` (``ca/down``, ``ca/up`` -> ``se.1``,
``se.3``) and ``NAFSSR`` (``blk{i}/blk`` -> ``body.{i}.blk``,
``blk{i}/scam`` -> ``body.{i}.scam``).

:func:`lpips_params_from_jax` and :func:`inception_params_from_jax` carry
the Flax ``LPIPSNet`` (``trunk/conv*`` HWIO -> OIHW, ``lin{i}`` ``[C]`` ->
``[1, C, 1, 1]``) and ``InceptionV3Pool3`` (each ``BasicConv``'s
``kernel`` and BatchNorm ``bn_scale``, ``bn_bias``, ``bn_mean``,
``bn_var`` -> ``<path>.conv.weight``, ``<path>.bn.weight``, ``.bias``,
``.running_mean``, ``.running_var``) into the port's modules.

:func:`unet_params_from_jax`, :func:`swinir_params_from_jax` and
:func:`nafnet_tpu_params_from_jax` carry the Flax ``UNetSID`` (``inc``,
``down{i}``, ``bottom``, ``upconv{i}``, ``up{i}``, ``outc``; a
ConvTranspose kernel HWIO -> ``[in, out, kh, kw]`` spatially flipped, as
``tools/convert_torch_unet.py`` maps the other way), ``SwinIR``
(``rstb{i}/blk{j}`` -> ``layers.{i}.residual_group.blocks.{j}``, Dense
``[in, out]`` -> Linear ``[out, in]``, LayerNorm ``scale`` -> ``weight``)
and ``NAFNetTPU`` (``trunk`` -> ``trunk.*``) into the port's modules.
:func:`bridge_for` names the bridge of a port module.

An unknown or missing key, or a tree that does not fit ``model``, raises
``KeyError``.
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
        _prefixed(sd, name, _norm(sub[name], f"{where}/{name}"))
    sd["beta"], sd["gamma"] = _scale(sub["beta"]), _scale(sub["gamma"])
    return sd


def _norm(sub, where: str) -> Dict[str, torch.Tensor]:
    w, b = _leaves(sub, where, ("weight", "bias"))
    return {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)}


def _scale(leaf) -> torch.Tensor:
    """A residual scale ``[C]`` -> ``[1, C, 1, 1]``."""
    return torch.from_numpy(np.array(leaf, np.float32).reshape(1, -1, 1, 1))


def _prefixed(sd: Dict[str, torch.Tensor], prefix: str,
              sub: Dict[str, torch.Tensor]) -> None:
    for k, v in sub.items():
        sd[f"{prefix}.{k}"] = v


def baseline_block_state_from_jax(sub: Mapping[str, Any],
                                  where: str = "block"
                                  ) -> Dict[str, torch.Tensor]:
    """One Flax BaselineBlock subtree -> the port's BaselineBlock
    ``state_dict`` (``ca/down`` -> ``se.1``, ``ca/up`` -> ``se.3``)."""
    _check_keys(sub, where, (*_BLOCK_CONVS, "ca", "norm1", "norm2", "beta",
                             "gamma"))
    _check_keys(sub["ca"], f"{where}/ca", ("down", "up"))
    sd: Dict[str, torch.Tensor] = {}
    for name in _BLOCK_CONVS:
        _prefixed(sd, name, _conv(sub[name], f"{where}/{name}"))
    _prefixed(sd, "se.1", _conv(sub["ca"]["down"], f"{where}/ca/down"))
    _prefixed(sd, "se.3", _conv(sub["ca"]["up"], f"{where}/ca/up"))
    for name in ("norm1", "norm2"):
        _prefixed(sd, name, _norm(sub[name], f"{where}/{name}"))
    sd["beta"], sd["gamma"] = _scale(sub["beta"]), _scale(sub["gamma"])
    return sd


def _check_fit(sd: Dict[str, torch.Tensor], model) -> None:
    """``sd`` must hold exactly ``model``'s parameter names and shapes."""
    if model is None:
        return
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if want != got:
        raise KeyError(
            f"parameters do not fit the model: missing "
            f"{sorted(set(want) - set(got))}, unknown "
            f"{sorted(set(got) - set(want))}, shape mismatch "
            f"{sorted(k for k in set(want) & set(got) if want[k] != got[k])}")


def _ushaped_from_jax(tree: Mapping[str, Any], block, model, what: str
                      ) -> Dict[str, torch.Tensor]:
    """The U-shaped tree both NAFNet and Baseline use; ``block(sub, where)``
    converts one block subtree."""
    sd: Dict[str, torch.Tensor] = {}
    for key in ("intro", "ending"):
        if key not in tree:
            raise KeyError(f"missing {what} parameter group {key!r}")
    for key, sub in unstack_block_params(tree).items():
        if key in ("intro", "ending"):
            prefix, conv = key, _conv(sub, key)
        elif m := re.fullmatch(r"down(\d+)", key):
            prefix, conv = f"downs.{m.group(1)}", _conv(sub, key)
        elif m := re.fullmatch(r"up(\d+)", key):
            prefix, conv = f"ups.{m.group(1)}.0", _conv(sub, key, bias=False)
        elif m := re.fullmatch(r"(enc|dec)(\d+)_blk(\d+)", key):
            stage, s, b = m.groups()
            prefix, conv = f"{_STAGE[stage]}.{s}.{b}", block(sub, key)
        elif m := re.fullmatch(r"mid_blk(\d+)", key):
            prefix, conv = f"middle_blks.{m.group(1)}", block(sub, key)
        else:
            raise KeyError(f"unknown {what} parameter group {key!r}")
        _prefixed(sd, prefix, conv)
    _check_fit(sd, model)
    return sd


def params_from_jax(tree: Mapping[str, Any],
                    model: torch.nn.Module = None) -> Dict[str, torch.Tensor]:
    """JAX NAFNet params (numpy leaves) -> the port's NAFNet ``state_dict``.

    With ``model``, the result must hold exactly ``model``'s parameter
    names and shapes."""
    return _ushaped_from_jax(tree, block_state_from_jax, model, "NAFNet")


def baseline_params_from_jax(tree: Mapping[str, Any],
                             model: torch.nn.Module = None
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``Baseline`` params (numpy leaves) -> the port's ``Baseline``
    ``state_dict``; ``model`` as in :func:`params_from_jax`."""
    return _ushaped_from_jax(tree, baseline_block_state_from_jax, model,
                             "Baseline")


_SCAM_CONVS = ("l_proj1", "r_proj1", "l_proj2", "r_proj2")


def nafssr_params_from_jax(tree: Mapping[str, Any],
                           model: torch.nn.Module = None
                           ) -> Dict[str, torch.Tensor]:
    """JAX ``NAFSSR`` params (numpy leaves; ``intro``, ``up``, ``blk{i}``
    with ``blk`` and, where the block fuses, ``scam``) -> the port's
    ``NAFSSR`` ``state_dict`` (``body.{i}.blk.*``, ``body.{i}.scam.*``);
    ``model`` as in :func:`params_from_jax`."""
    sd: Dict[str, torch.Tensor] = {}
    for key in ("intro", "up"):
        if key not in tree:
            raise KeyError(f"missing NAFSSR parameter group {key!r}")
    for key, sub in tree.items():
        if key in ("intro", "up"):
            _prefixed(sd, key, _conv(sub, key))
            continue
        m = re.fullmatch(r"blk(\d+)", key)
        if not m:
            raise KeyError(f"unknown NAFSSR parameter group {key!r}")
        prefix = f"body.{m.group(1)}"
        if not isinstance(sub, Mapping) or not {"blk"} <= set(sub) <= {
                "blk", "scam"}:
            raise KeyError(f"{key}: expected 'blk' and optionally 'scam', "
                           f"got {sorted(sub)}")
        _prefixed(sd, f"{prefix}.blk",
                  block_state_from_jax(sub["blk"], f"{key}/blk"))
        if "scam" in sub:
            scam, where = sub["scam"], f"{key}/scam"
            _check_keys(scam, where, (*_SCAM_CONVS, "norm_l", "norm_r",
                                      "beta", "gamma"))
            for name in _SCAM_CONVS:
                _prefixed(sd, f"{prefix}.scam.{name}",
                          _conv(scam[name], f"{where}/{name}"))
            for name in ("norm_l", "norm_r"):
                _prefixed(sd, f"{prefix}.scam.{name}",
                          _norm(scam[name], f"{where}/{name}"))
            for name in ("beta", "gamma"):
                sd[f"{prefix}.scam.{name}"] = _scale(scam[name])
    _check_fit(sd, model)
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


def _params(variables: Mapping[str, Any]) -> Mapping[str, Any]:
    """The ``params`` collection of Flax ``variables`` (or the tree
    itself when it is already one)."""
    return variables["params"] if "params" in variables else variables


def lpips_params_from_jax(variables: Mapping[str, Any],
                          net: str) -> Dict[str, torch.Tensor]:
    """Flax ``LPIPSNet(net=net)`` variables (numpy leaves) -> the port's
    :class:`...models.lpips.LPIPSNet` ``state_dict``."""
    from lowlight_image_enhancement_tpu_torch.models.lpips import (
        N_CHANNELS, LPIPSNet)

    model = LPIPSNet(net=net)
    tree = _params(variables)
    heads = [f"lin{i}" for i in range(len(N_CHANNELS[net]))]
    _check_keys(tree, "LPIPS", ("trunk", *heads))
    names = [n for n, _ in model.trunk.named_children()]
    _check_keys(tree["trunk"], "LPIPS trunk", names)
    sd: Dict[str, torch.Tensor] = {}
    for name in names:
        _prefixed(sd, f"trunk.{name}", _conv(tree["trunk"][name], name))
    for head in heads:
        sd[f"{head}.weight"] = torch.from_numpy(
            np.array(tree[head], np.float32).reshape(1, -1, 1, 1))
    _check_fit(sd, model)
    return sd


_BN = (("bn_scale", "bn.weight"), ("bn_bias", "bn.bias"),
       ("bn_mean", "bn.running_mean"), ("bn_var", "bn.running_var"))


def inception_params_from_jax(variables: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """Flax ``InceptionV3Pool3`` variables (numpy leaves) -> the port's
    :class:`...models.inception.InceptionV3Pool3` ``state_dict`` (its
    BatchNorms' ``num_batches_tracked`` stay 0)."""
    from lowlight_image_enhancement_tpu_torch.models.inception import (
        InceptionV3Pool3)

    model = InceptionV3Pool3()
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if "kernel" in tree:
            where = "/".join(path)
            leaves = _leaves(tree, where, ("kernel",) + tuple(
                k for k, _ in _BN))
            base = ".".join(path)
            sd[f"{base}.conv.weight"] = _oihw(leaves[0])
            for (_, name), val in zip(_BN, leaves[1:]):
                sd[f"{base}.{name}"] = torch.from_numpy(val)
            sd[f"{base}.bn.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
            return
        for key, sub in tree.items():
            walk(sub, path + (key,))

    walk(_params(variables), ())
    _check_fit(sd, model)
    return sd


def _dense(sub, where: str) -> Dict[str, torch.Tensor]:
    """Flax Dense ``kernel [in, out]``, ``bias`` -> Linear ``weight [out,
    in]``, ``bias``."""
    k, b = _leaves(sub, where, ("kernel", "bias"))
    return {"weight": torch.from_numpy(np.ascontiguousarray(k.T)),
            "bias": torch.from_numpy(b)}


def _layer_norm(sub, where: str) -> Dict[str, torch.Tensor]:
    """Flax LayerNorm / GroupNorm ``scale``, ``bias`` -> ``weight``,
    ``bias``."""
    w, b = _leaves(sub, where, ("scale", "bias"))
    return {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)}


def _double_conv(sub, where: str) -> Dict[str, torch.Tensor]:
    """A Flax ``DoubleConv`` (``conv1``, ``conv2``, with GroupNorm also
    ``norm1``, ``norm2``) -> ``block.{i}`` of the port's ``DoubleConv``."""
    group = isinstance(sub, Mapping) and "norm1" in sub
    names = ("conv1", "conv2") + (("norm1", "norm2") if group else ())
    _check_keys(sub, where, names)
    step = 3 if group else 2
    sd: Dict[str, torch.Tensor] = {}
    for i in range(2):
        _prefixed(sd, f"block.{step * i}",
                  _conv(sub[f"conv{i + 1}"], f"{where}/conv{i + 1}"))
        if group:
            _prefixed(sd, f"block.{step * i + 1}",
                      _layer_norm(sub[f"norm{i + 1}"], f"{where}/norm{i + 1}"))
    return sd


def unet_params_from_jax(tree: Mapping[str, Any],
                         model: torch.nn.Module = None
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``UNetSID`` params (numpy leaves) -> the port's ``UNetSID``
    ``state_dict``; ``model`` as in :func:`params_from_jax`. An ``upconv``
    kernel of 2x2 is the ConvTranspose of ``bilinear=False`` (flipped), one
    of 1x1 the conv of ``bilinear=True``."""
    sd: Dict[str, torch.Tensor] = {}
    for key in ("inc", "bottom", "outc"):
        if key not in tree:
            raise KeyError(f"missing UNetSID parameter group {key!r}")
    for key, sub in tree.items():
        if key in ("inc", "bottom"):
            _prefixed(sd, key, _double_conv(sub, key))
        elif key == "outc":
            _prefixed(sd, key, _conv(sub, key))
        elif m := re.fullmatch(r"down(\d+)", key):
            _prefixed(sd, f"down_layers.{int(m.group(1)) - 1}.block.1",
                      _double_conv(sub, key))
        elif m := re.fullmatch(r"up(\d+)", key):
            _prefixed(sd, f"up_layers.{int(m.group(1)) - 1}.conv",
                      _double_conv(sub, key))
        elif m := re.fullmatch(r"upconv(\d+)", key):
            k, b = _leaves(sub, key, ("kernel", "bias"))
            if k.shape[:2] == (2, 2):   # ConvTranspose: [in, out, kh, kw]
                w = torch.from_numpy(np.ascontiguousarray(
                    k[::-1, ::-1].transpose(2, 3, 0, 1)))
            else:
                w = _oihw(k)
            prefix = f"up_layers.{int(m.group(1)) - 1}.up"
            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = (
                w, torch.from_numpy(b))
        else:
            raise KeyError(f"unknown UNetSID parameter group {key!r}")
    _check_fit(sd, model)
    return sd


_SWIN_BLOCK = ("norm1", "attn", "norm2", "fc1", "fc2")


def swinir_params_from_jax(tree: Mapping[str, Any],
                           model: torch.nn.Module = None
                           ) -> Dict[str, torch.Tensor]:
    """JAX ``SwinIR`` params (numpy leaves) -> the port's ``SwinIR``
    ``state_dict`` (the official names); ``model`` as in
    :func:`params_from_jax`."""
    sd: Dict[str, torch.Tensor] = {}
    for key in ("conv_first", "norm", "conv_after_body", "conv_last"):
        if key not in tree:
            raise KeyError(f"missing SwinIR parameter group {key!r}")
    for key, sub in tree.items():
        if key in ("conv_first", "conv_after_body", "conv_last"):
            _prefixed(sd, key, _conv(sub, key))
        elif key == "norm":
            _prefixed(sd, key, _layer_norm(sub, key))
        elif key == "patch_embed_norm":
            _prefixed(sd, "patch_embed.norm", _layer_norm(sub, key))
        elif m := re.fullmatch(r"rstb(\d+)", key):
            layer = f"layers.{m.group(1)}"
            blocks = [k for k in sub if k != "conv"] if isinstance(
                sub, Mapping) else []
            _check_keys(sub, key, ("conv", *blocks))
            _prefixed(sd, f"{layer}.conv", _conv(sub["conv"], f"{key}/conv"))
            for blk in blocks:
                bm = re.fullmatch(r"blk(\d+)", blk)
                if not bm:
                    raise KeyError(f"unknown SwinIR group {key}/{blk}")
                where = f"{key}/{blk}"
                prefix = f"{layer}.residual_group.blocks.{bm.group(1)}"
                b = sub[blk]
                _check_keys(b, where, _SWIN_BLOCK)
                _check_keys(b["attn"], f"{where}/attn",
                            ("qkv", "proj", "relative_position_bias"))
                for name in ("norm1", "norm2"):
                    _prefixed(sd, f"{prefix}.{name}",
                              _layer_norm(b[name], f"{where}/{name}"))
                for name in ("qkv", "proj"):
                    _prefixed(sd, f"{prefix}.attn.{name}",
                              _dense(b["attn"][name], f"{where}/attn/{name}"))
                sd[f"{prefix}.attn.relative_position_bias_table"] = (
                    torch.from_numpy(np.array(
                        b["attn"]["relative_position_bias"], np.float32)))
                for name in ("fc1", "fc2"):
                    _prefixed(sd, f"{prefix}.mlp.{name}",
                              _dense(b[name], f"{where}/{name}"))
        else:
            raise KeyError(f"unknown SwinIR parameter group {key!r}")
    _check_fit(sd, model)
    return sd


def nafnet_tpu_params_from_jax(tree: Mapping[str, Any],
                               model: torch.nn.Module = None
                               ) -> Dict[str, torch.Tensor]:
    """JAX ``NAFNetTPU`` params (``trunk``: a NAFNet tree) -> the port's
    ``NAFNetTPU`` ``state_dict`` (``trunk.*``); ``model`` as in
    :func:`params_from_jax`."""
    _check_keys(tree, "NAFNetTPU", ("trunk",))
    sd: Dict[str, torch.Tensor] = {}
    _prefixed(sd, "trunk", params_from_jax(tree["trunk"]))
    _check_fit(sd, model)
    return sd


def bridge_for(model: torch.nn.Module):
    """The ``*_params_from_jax`` function of a port model."""
    from lowlight_image_enhancement_tpu_torch.models import (
        NAFSSR, Baseline, NAFNetTPU, SwinIR, UNetSID)

    for cls, bridge in ((Baseline, baseline_params_from_jax),
                        (NAFSSR, nafssr_params_from_jax),
                        (NAFNetTPU, nafnet_tpu_params_from_jax),
                        (UNetSID, unet_params_from_jax),
                        (SwinIR, swinir_params_from_jax)):
        if isinstance(model, cls):
            return bridge
    return params_from_jax
