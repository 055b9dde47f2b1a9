"""Plain SwinIR forward (NCHW), restoration path, the benchmark's frozen copy
of the math.

Written from the SwinIR paper (Liang et al., 2021) and JingyunLiang/SwinIR
``models/network_swinir.py`` with ``upscale=1, upsampler=''`` and
``resi_connection='1conv'`` (task ``color_dn`` of ``main_test_swinir.py``):

- the input is reflect-padded to a multiple of the window on the bottom
  and right, the RGB mean (0.4488, 0.4371, 0.4040) is subtracted and the
  result scaled by ``img_range``;
- ``conv_first`` (3x3) gives the shallow features ``f``; the tokens are
  ``f`` flattened, under the patch-embed LayerNorm;
- each RSTB runs ``depth`` Swin blocks, then a 3x3 ``conv`` on the
  unflattened tokens, plus the RSTB's input;
- a Swin block is ``x + W-MSA(LN(x))``, then ``x + MLP(LN(x))``. Every
  second block of an RSTB rolls the tokens by ``-window/2`` on both axes
  before the windows are cut, masks attention between tokens of different
  regions of the rolled image (-100 on the logits), and rolls back;
- W-MSA on a window of ``n = window^2`` tokens: ``qkv`` Linear (C -> 3C),
  heads of ``C / heads``, ``softmax(q k^T / sqrt(d) + B + M) v`` with the
  relative-position bias ``B`` gathered from
  ``relative_position_bias_table`` by the pairwise index of the window's
  coordinates, then ``proj`` (C -> C);
- the MLP is Linear (C -> mlp_ratio C), exact GELU, Linear back;
- after the last RSTB, a LayerNorm, ``conv_after_body`` (3x3) plus ``f``,
  ``conv_last`` (3x3) plus the normalised input; then divided by
  ``img_range``, the mean added back, cropped to the input's size.

Departures from the official module, each the measured port's:

- every LayerNorm has eps 1e-6 (the port's, after the Flax module; the
  official ``nn.LayerNorm`` has 1e-5);
- the shift is dropped where the padded image's shorter side is at most
  one window (the official module decides from the ``img_size`` it was
  built with, and also shrinks the window there);
- dropout, attention dropout and drop-path are identity (their rates are
  0 in ``color_dn``); ``ape`` is off and ``qkv_bias`` on, as there.

Parameters are a plain ``{name: tensor}`` dict with the official names
(``layers.{i}.residual_group.blocks.{j}.attn.qkv.weight``, ...), which the
port keeps. The relative-position index and the shift mask are built with
``torch`` operations on the input's device, so the forward runs on meta
tensors and ``FlopCounterMode`` counts the network there: the linears, the
convolutions and the two attention products. Nothing here imports the
measured program. ``forward`` turns TF32 off (matmul and cuDNN) before
it computes, and leaves it off: the harness runs it after the measured
run, with TF32 off already.

``quant`` (optional) rounds every tensor the network stores between its
operations (each convolution's and linear's operands and result, the
LayerNorms' and GELU's outputs, the logits, the attention weights, the
weighted sums, the residual stream): see ``port_bench.reference.ops``.
The harness reads the module through ``param_shapes``, ``forward``,
``in_channels`` and ``init`` (``port_bench/harness/spec.py``); ``small``
narrows a ``network_g`` for the CPU tests.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from port_bench.reference.ops import Quant, conv, keep

Params = Dict[str, torch.Tensor]
RGB_MEAN = (0.4488, 0.4371, 0.4040)
LN_EPS = 1e-6
# the relative-position tables: truncated normal, std 0.02, cut at +-2 as
# timm's ``trunc_normal_`` (the official init) cuts it
TABLE_STD, TABLE_CUT = 0.02, 2.0


def param_shapes(network_g: Mapping[str, Any]) -> Dict[str, tuple]:
    """The port network's ``state_dict`` keys and shapes, in draw order."""
    c = int(network_g["embed_dim"])
    ch = int(network_g["img_channel"])
    ws = int(network_g["window_size"])
    hidden = int(c * float(network_g["mlp_ratio"]))
    shapes: Dict[str, tuple] = {
        "conv_first.weight": (c, ch, 3, 3), "conv_first.bias": (c,),
        "patch_embed.norm.weight": (c,), "patch_embed.norm.bias": (c,)}
    for i, depth in enumerate(network_g["depths"]):
        heads = int(network_g["num_heads"][i])
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            for key, shape in (
                    ("norm1.weight", (c,)), ("norm1.bias", (c,)),
                    ("attn.relative_position_bias_table",
                     ((2 * ws - 1) ** 2, heads)),
                    ("attn.qkv.weight", (3 * c, c)), ("attn.qkv.bias", (3 * c,)),
                    ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
                    ("norm2.weight", (c,)), ("norm2.bias", (c,)),
                    ("mlp.fc1.weight", (hidden, c)), ("mlp.fc1.bias", (hidden,)),
                    ("mlp.fc2.weight", (c, hidden)), ("mlp.fc2.bias", (c,))):
                shapes[f"{b}.{key}"] = shape
        shapes[f"layers.{i}.conv.weight"] = (c, c, 3, 3)
        shapes[f"layers.{i}.conv.bias"] = (c,)
    shapes.update({
        "norm.weight": (c,), "norm.bias": (c,),
        "conv_after_body.weight": (c, c, 3, 3), "conv_after_body.bias": (c,),
        "conv_last.weight": (ch, c, 3, 3), "conv_last.bias": (ch,)})
    return shapes


def init(name: str, shape: tuple, u: torch.Tensor) -> Optional[torch.Tensor]:
    """A relative-position table from its uniform draw ``u``: the inverse
    normal CDF, std 0.02, cut at +-2. Every other leaf: the default rule."""
    if not name.endswith("relative_position_bias_table"):
        return None
    z = torch.special.ndtri(u.double().clamp(1e-12, 1.0 - 1e-12))
    return (TABLE_STD * z).clamp(-TABLE_CUT, TABLE_CUT).float()


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           quant: Quant = None) -> torch.Tensor:
    if quant is not None:
        x, w = quant(x), quant(w)
    return keep(F.linear(x, w, b), quant)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               quant: Quant = None) -> torch.Tensor:
    """LayerNorm over the last axis, eps 1e-6."""
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return keep(xc * torch.rsqrt(var + LN_EPS) * w + b, quant)


def relative_index(ws: int, device) -> torch.Tensor:
    """``[n, n]`` index into the table of a ``ws x ws`` window: the
    official ``relative_position_index``."""
    r = torch.arange(ws, device=device)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :] + (ws - 1)
    return rel[0] * (2 * ws - 1) + rel[1]


def shift_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    """``[nW, n, n]``: -100 between tokens of a window that came from
    different regions of the rolled image, else 0 (the official
    ``calculate_mask``)."""
    img = torch.zeros(h, w, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, torch.full_like(diff, -100.0),
                       torch.zeros_like(diff))


def window_attention(x: torch.Tensor, p: Params, prefix: str, heads: int,
                     ws: int, mask: Optional[torch.Tensor],
                     quant: Quant = None) -> torch.Tensor:
    """W-MSA on ``[B_, n, C]`` windows."""
    b, n, c = x.shape
    d = c // heads
    qkv = linear(x, p[f"{prefix}.qkv.weight"], p[f"{prefix}.qkv.bias"], quant)
    qkv = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
    attn = keep(q @ k.transpose(-2, -1), quant)
    table = p[f"{prefix}.relative_position_bias_table"]
    bias = table[relative_index(ws, x.device).reshape(-1)]
    attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(b // nw, nw, heads, n, n)
                + mask[None, :, None]).reshape(b, heads, n, n)
    attn = keep(torch.softmax(attn, dim=-1), quant)
    out = keep(attn @ v, quant).transpose(1, 2).reshape(b, n, c)
    return linear(out, p[f"{prefix}.proj.weight"], p[f"{prefix}.proj.bias"],
                  quant)


def swin_block(x: torch.Tensor, p: Params, prefix: str, heads: int, ws: int,
               shift: int, quant: Quant = None) -> torch.Tensor:
    """One Swin block on ``[N, H, W, C]`` tokens."""
    n, h, w, c = x.shape
    g = lambda k: p[f"{prefix}.{k}"]
    if min(h, w) <= ws:
        shift = 0
    y = layer_norm(x, g("norm1.weight"), g("norm1.bias"), quant)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    wins = y.reshape(n, h // ws, ws, w // ws, ws, c).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
    mask = shift_mask(h, w, ws, shift, x.device) if shift else None
    wins = window_attention(wins, p, f"{prefix}.attn", heads, ws, mask, quant)
    y = wins.reshape(n, h // ws, w // ws, ws, ws, c).permute(
        0, 1, 3, 2, 4, 5).reshape(n, h, w, c)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    x = keep(x + y, quant)
    y = layer_norm(x, g("norm2.weight"), g("norm2.bias"), quant)
    y = keep(F.gelu(linear(y, g("mlp.fc1.weight"), g("mlp.fc1.bias"), quant)),
             quant)
    y = linear(y, g("mlp.fc2.weight"), g("mlp.fc2.bias"), quant)
    return keep(x + y, quant)


def swinir(inp: torch.Tensor, p: Params, network_g: Mapping[str, Any],
           quant: Quant = None) -> torch.Tensor:
    """SwinIR on fp32 NCHW ``inp``; returns ``[N, C, H, W]``."""
    ws = int(network_g["window_size"])
    img_range = float(network_g.get("img_range", 1.0))
    _, ch, h, w = inp.shape
    x = F.pad(inp, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws),
              mode="reflect")
    mean = torch.tensor(RGB_MEAN if ch == 3 else (0.0,) * ch,
                        device=inp.device).view(1, ch, 1, 1)
    x = (x - mean) * img_range
    f = conv(x, p["conv_first.weight"], p["conv_first.bias"], quant,
             padding=1)
    y = layer_norm(f.permute(0, 2, 3, 1), p["patch_embed.norm.weight"],
                   p["patch_embed.norm.bias"], quant)
    for i, depth in enumerate(network_g["depths"]):
        heads = int(network_g["num_heads"][i])
        z = y
        for j in range(depth):
            z = swin_block(z, p, f"layers.{i}.residual_group.blocks.{j}",
                           heads, ws, 0 if j % 2 == 0 else ws // 2, quant)
        z = conv(z.permute(0, 3, 1, 2), p[f"layers.{i}.conv.weight"],
                 p[f"layers.{i}.conv.bias"], quant, padding=1)
        y = keep(y + z.permute(0, 2, 3, 1), quant)
    y = layer_norm(y, p["norm.weight"], p["norm.bias"], quant)
    y = keep(conv(y.permute(0, 3, 1, 2), p["conv_after_body.weight"],
                  p["conv_after_body.bias"], quant, padding=1) + f, quant)
    out = keep(conv(y, p["conv_last.weight"], p["conv_last.bias"], quant,
                    padding=1) + x, quant)
    return (out / img_range + mean)[:, :, :h, :w]


# The harness's interface (``port_bench/harness/spec.py``).

def forward(x: torch.Tensor, params: Params, network_g: Mapping[str, Any],
            quant: Quant = None) -> torch.Tensor:
    # a float32 product here is a float32 product, never TF32: set on
    # each call (not at import, where it would reach the measured run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return swinir(x, params, network_g, quant)


def in_channels(network_g: Mapping[str, Any]) -> int:
    return int(network_g["img_channel"])


def small(network_g: Mapping[str, Any]) -> Dict[str, Any]:
    """``network_g`` narrowed and shallowed to a size a CPU test holds."""
    return dict(network_g, embed_dim=12, depths=[2, 2], num_heads=[2, 2],
                window_size=8, mlp_ratio=2.0)

