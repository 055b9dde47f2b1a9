"""Plain Baseline forward (NCHW, fp32): a second architecture's reference,
written for ``test_port_bench_second_architecture.py``.

NAFNet's ablation ``Baseline`` (megvii-research/NAFNet
``basicsr/models/archs/Baseline_arch.py``): the NAFNet U-shape (3x3
intro, stages of blocks with 2x2 stride-2 downs, a 1x1 no-bias conv +
PixelShuffle(2) up and a skip add, 3x3 ending, global input residual, the
input zero-padded to a multiple of ``2 ** len(enc_blk_nums)``) around a
block LN -> 1x1 (C -> D) -> depthwise 3x3 -> GELU -> squeeze-and-excite
(global mean, 1x1 D -> D/2, ReLU, 1x1 D/2 -> D, sigmoid) -> 1x1 (D -> C),
residual scaled by ``beta``; LN -> 1x1 (C -> F) -> GELU -> 1x1 (F -> C),
residual scaled by ``gamma``; D = ``dw_expand`` C, F = ``ffn_expand`` C.

It gives the interface of a configuration's ``reference``
(``port_bench/harness/spec.py``) for ``network_g`` of type ``Baseline``,
and imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from port_bench.reference.ops import Quant, conv, keep, layer_norm

Params = Dict[str, torch.Tensor]


def _stages(net: Mapping[str, Any]):
    """``(prefix, channels)`` of every block, in forward order."""
    out, chan = [], net["width"]
    for s, num in enumerate(net["enc_blk_nums"]):
        out += [(f"encoders.{s}.{b}", chan) for b in range(num)]
        chan *= 2
    out += [(f"middle_blks.{b}", chan) for b in range(net["middle_blk_num"])]
    for s, num in enumerate(net["dec_blk_nums"]):
        chan //= 2
        out += [(f"decoders.{s}.{b}", chan) for b in range(num)]
    return out


def param_shapes(net: Mapping[str, Any]) -> Dict[str, tuple]:
    ch, width = net["img_channel"], net["width"]
    shapes: Dict[str, tuple] = {
        "intro.weight": (width, ch, 3, 3), "intro.bias": (width,),
        "ending.weight": (ch, width, 3, 3), "ending.bias": (ch,)}
    chan = width
    for s, _ in enumerate(net["enc_blk_nums"]):
        shapes[f"downs.{s}.weight"] = (2 * chan, chan, 2, 2)
        shapes[f"downs.{s}.bias"] = (2 * chan,)
        chan *= 2
    for s, _ in enumerate(net["dec_blk_nums"]):
        shapes[f"ups.{s}.0.weight"] = (2 * chan, chan, 1, 1)
        chan //= 2
    for prefix, c in _stages(net):
        d = c * net.get("dw_expand", 1)
        f = c * net.get("ffn_expand", 2)
        for key, shape in (
                ("conv1.weight", (d, c, 1, 1)), ("conv1.bias", (d,)),
                ("conv2.weight", (d, 1, 3, 3)), ("conv2.bias", (d,)),
                ("conv3.weight", (c, d, 1, 1)), ("conv3.bias", (c,)),
                ("se.1.weight", (d // 2, d, 1, 1)), ("se.1.bias", (d // 2,)),
                ("se.3.weight", (d, d // 2, 1, 1)), ("se.3.bias", (d,)),
                ("conv4.weight", (f, c, 1, 1)), ("conv4.bias", (f,)),
                ("conv5.weight", (c, f, 1, 1)), ("conv5.bias", (c,)),
                ("norm1.weight", (c,)), ("norm1.bias", (c,)),
                ("norm2.weight", (c,)), ("norm2.bias", (c,)),
                ("beta", (1, c, 1, 1)), ("gamma", (1, c, 1, 1))):
            shapes[f"{prefix}.{key}"] = shape
    return shapes


def block(x: torch.Tensor, p: Params, prefix: str,
          quant: Quant = None) -> torch.Tensor:
    g = lambda k: p[f"{prefix}.{k}"]
    d = g("conv2.weight").shape[0]
    y = conv(layer_norm(x, g("norm1.weight"), g("norm1.bias")),
             g("conv1.weight"), g("conv1.bias"), quant)
    y = keep(F.gelu(conv(y, g("conv2.weight"), g("conv2.bias"), quant,
                         padding=1, groups=d)), quant)
    a = F.relu(conv(y.mean((2, 3), keepdim=True), g("se.1.weight"),
                    g("se.1.bias"), quant))
    a = torch.sigmoid(conv(a, g("se.3.weight"), g("se.3.bias"), quant))
    y = conv(keep(y * a, quant), g("conv3.weight"), g("conv3.bias"), quant)
    z = keep(x + y * g("beta"), quant)
    y = conv(layer_norm(z, g("norm2.weight"), g("norm2.bias")),
             g("conv4.weight"), g("conv4.bias"), quant)
    y = conv(keep(F.gelu(y), quant), g("conv5.weight"), g("conv5.bias"),
             quant)
    return keep(z + y * g("gamma"), quant)


def forward(inp: torch.Tensor, p: Params, net: Mapping[str, Any],
            quant: Quant = None) -> torch.Tensor:
    enc, dec = net["enc_blk_nums"], net["dec_blk_nums"]
    _, _, h, w = inp.shape
    m = 2 ** len(enc)
    inp = F.pad(inp, (0, (m - w % m) % m, 0, (m - h % m) % m))
    x = conv(inp, p["intro.weight"], p["intro.bias"], quant, padding=1)
    skips = []
    for s, num in enumerate(enc):
        for b in range(num):
            x = block(x, p, f"encoders.{s}.{b}", quant)
        skips.append(x)
        x = conv(x, p[f"downs.{s}.weight"], p[f"downs.{s}.bias"], quant,
                 stride=2)
    for b in range(net["middle_blk_num"]):
        x = block(x, p, f"middle_blks.{b}", quant)
    for s, num in enumerate(dec):
        x = F.pixel_shuffle(conv(x, p[f"ups.{s}.0.weight"], None, quant), 2)
        x = keep(x + skips[len(enc) - 1 - s], quant)
        for b in range(num):
            x = block(x, p, f"decoders.{s}.{b}", quant)
    x = keep(conv(x, p["ending.weight"], p["ending.bias"], quant, padding=1)
             + inp, quant)
    return x[:, :, :h, :w]


def in_channels(net: Mapping[str, Any]) -> int:
    return int(net["img_channel"])


def small(net: Mapping[str, Any]) -> Dict[str, Any]:
    return dict(net, width=8, enc_blk_nums=[1, 1], middle_blk_num=1,
                dec_blk_nums=[1, 1])
