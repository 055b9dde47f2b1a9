"""Plain NAFNet forward (NCHW), the benchmark's frozen copy of the math.

Written from the NAFNet paper and megvii-research/NAFNet
``basicsr/models/archs/NAFNet_arch.py``: 3x3 intro, encoder stages of
NAFBlocks with 2x2 stride-2 downs, middle blocks, decoder stages with a
1x1 no-bias conv + PixelShuffle(2) up and a skip add, 3x3 ending, global
input residual; the input is zero-padded to a multiple of
``2 ** len(enc_blk_nums)`` and cropped back. A NAFBlock is
LN -> 1x1 (C -> 2C) -> depthwise 3x3 -> SimpleGate -> SCA (global mean,
1x1) -> 1x1 (C -> C), residual scaled by ``beta``; LN -> 1x1 (C -> 2C)
-> SimpleGate -> 1x1 (C -> C), residual scaled by ``gamma``. LayerNorm
over channels, eps 1e-6, statistics in fp32.

Parameters are a plain ``{name: tensor}`` dict with the reference torch
NAFNet's names (``intro.weight``, ``encoders.0.1.conv2.bias``,
``ups.3.0.weight``, ...). Nothing here imports the measured program.

``quant`` (optional) rounds every tensor the network stores between its
operations (each convolution's operands and result, the gated products,
the residual stream, the output): see ``port_bench.reference.ops``.

The module is a configuration's ``reference`` (``port_bench/configs/
<name>.json``) for the network types that build a plain NAFNet from
``network_g["nafnet_params"]`` (``NewBPNAFNet``). The harness reads it
through ``param_shapes``, ``forward``, ``in_channels`` and ``counted``
(the interface: ``port_bench/harness/spec.py``); ``small`` narrows a
``network_g`` for the CPU tests.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.ops import Quant, conv, keep, layer_norm

Params = Dict[str, torch.Tensor]


def block_names(width: int, enc: Sequence[int], middle: int,
                dec: Sequence[int]) -> List[Tuple[str, int]]:
    """``(prefix, channels)`` of every NAFBlock, in forward order."""
    out, chan = [], width
    for s, num in enumerate(enc):
        out += [(f"encoders.{s}.{b}", chan) for b in range(num)]
        chan *= 2
    out += [(f"middle_blks.{b}", chan) for b in range(middle)]
    for s, num in enumerate(dec):
        chan //= 2
        out += [(f"decoders.{s}.{b}", chan) for b in range(num)]
    return out


def nafnet_param_shapes(img_channel: int, width: int, enc: Sequence[int],
                        middle: int, dec: Sequence[int]) -> Dict[str, tuple]:
    """Every parameter's name and shape, as the reference NAFNet names
    them."""
    shapes: Dict[str, tuple] = {
        "intro.weight": (width, img_channel, 3, 3), "intro.bias": (width,),
        "ending.weight": (img_channel, width, 3, 3),
        "ending.bias": (img_channel,)}
    chan = width
    for s, _ in enumerate(enc):
        shapes[f"downs.{s}.weight"] = (2 * chan, chan, 2, 2)
        shapes[f"downs.{s}.bias"] = (2 * chan,)
        chan *= 2
    for s, _ in enumerate(dec):
        shapes[f"ups.{s}.0.weight"] = (2 * chan, chan, 1, 1)
        chan //= 2
    for prefix, c in block_names(width, enc, middle, dec):
        for key, shape in (
                ("conv1.weight", (2 * c, c, 1, 1)), ("conv1.bias", (2 * c,)),
                ("conv2.weight", (2 * c, 1, 3, 3)), ("conv2.bias", (2 * c,)),
                ("conv3.weight", (c, c, 1, 1)), ("conv3.bias", (c,)),
                ("sca.1.weight", (c, c, 1, 1)), ("sca.1.bias", (c,)),
                ("conv4.weight", (2 * c, c, 1, 1)), ("conv4.bias", (2 * c,)),
                ("conv5.weight", (c, c, 1, 1)), ("conv5.bias", (c,)),
                ("norm1.weight", (c,)), ("norm1.bias", (c,)),
                ("norm2.weight", (c,)), ("norm2.bias", (c,)),
                ("beta", (1, c, 1, 1)), ("gamma", (1, c, 1, 1))):
            shapes[f"{prefix}.{key}"] = shape
    return shapes


def gate(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=1)
    return a * b


def nafblock(x: torch.Tensor, p: Params, prefix: str,
             quant: Quant = None) -> torch.Tensor:
    g = lambda k: p[f"{prefix}.{k}"]
    c2 = g("conv2.weight").shape[0]
    y = layer_norm(x, g("norm1.weight"), g("norm1.bias"))
    y = conv(y, g("conv1.weight"), g("conv1.bias"), quant)
    y = conv(y, g("conv2.weight"), g("conv2.bias"), quant, padding=1,
             groups=c2)
    y = keep(gate(y), quant)
    att = conv(y.mean((2, 3), keepdim=True), g("sca.1.weight"),
               g("sca.1.bias"), quant)
    y = conv(y * att, g("conv3.weight"), g("conv3.bias"), quant)
    z = keep(x + y * g("beta"), quant)
    y = layer_norm(z, g("norm2.weight"), g("norm2.bias"))
    y = keep(gate(conv(y, g("conv4.weight"), g("conv4.bias"), quant)), quant)
    y = conv(y, g("conv5.weight"), g("conv5.bias"), quant)
    return keep(z + y * g("gamma"), quant)


def nafnet(inp: torch.Tensor, p: Params, enc: Sequence[int], middle: int,
           dec: Sequence[int], quant: Quant = None) -> torch.Tensor:
    """NAFNet on fp32 NCHW ``inp``; returns ``[N, C, H, W]``."""
    _, _, h, w = inp.shape
    m = 2 ** len(enc)
    inp = F.pad(inp, (0, (m - w % m) % m, 0, (m - h % m) % m))
    x = conv(inp, p["intro.weight"], p["intro.bias"], quant, padding=1)
    skips = []
    for s, num in enumerate(enc):
        for b in range(num):
            x = nafblock(x, p, f"encoders.{s}.{b}", quant)
        skips.append(x)
        x = conv(x, p[f"downs.{s}.weight"], p[f"downs.{s}.bias"], quant,
                 stride=2)
    for b in range(middle):
        x = nafblock(x, p, f"middle_blks.{b}", quant)
    for s, num in enumerate(dec):
        x = F.pixel_shuffle(conv(x, p[f"ups.{s}.0.weight"], None, quant), 2)
        x = keep(x + skips[len(enc) - 1 - s], quant)
        for b in range(num):
            x = nafblock(x, p, f"decoders.{s}.{b}", quant)
    x = keep(conv(x, p["ending.weight"], p["ending.bias"], quant, padding=1)
             + inp, quant)
    return x[:, :, :h, :w]


# The harness's interface (``port_bench/harness/spec.py``).

def param_shapes(network_g: Mapping[str, Any]) -> Dict[str, tuple]:
    """The port network's ``state_dict`` keys and shapes, in draw order."""
    p = network_g["nafnet_params"]
    return nafnet_param_shapes(p["img_channel"], p["width"],
                               p["enc_blk_nums"], p["middle_blk_num"],
                               p["dec_blk_nums"])


def forward(x: torch.Tensor, params: Params, network_g: Mapping[str, Any],
            quant: Quant = None) -> torch.Tensor:
    p = network_g["nafnet_params"]
    return nafnet(x, params, p["enc_blk_nums"], p["middle_blk_num"],
                  p["dec_blk_nums"], quant)


def in_channels(network_g: Mapping[str, Any]) -> int:
    return int(network_g["nafnet_params"]["img_channel"])


def block_shape(args: tuple) -> Tuple[int, ...]:
    """``(n, c, h, w)`` of a NAFBlock call's input."""
    return tuple(args[0].shape)


# the traced calls of each port module class, read by nafblock_roofline.*
counted = {"NAFBlock": block_shape}


def small(network_g: Mapping[str, Any]) -> Dict[str, Any]:
    """``network_g`` narrowed and shallowed to a size a CPU test holds."""
    return dict(network_g, nafnet_params=dict(
        network_g["nafnet_params"], width=8, enc_blk_nums=[1, 1],
        middle_blk_num=1, dec_blk_nums=[1, 1]))
