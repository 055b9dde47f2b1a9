"""SwinIR windowed-attention restoration network (NCHW in, NCHW out).

Counterpart of ``lowlight_image_enhancement_tpu/models/swinir.py``: the
official SwinIR restoration topology on the ``upsampler=''`` path --
mean / ``img_range`` input normalisation, reflect padding to a window
multiple, ``conv_first``, the patch-embed LayerNorm, RSTB stages
(shifted-window attention blocks + a 3x3 conv, residual), the trailing
LayerNorm, ``conv_after_body``, ``conv_last`` and the global residual.

Inside the body the tokens are channels-last (``[N, H, W, C]``): every
LayerNorm and Linear acts on the last axis. The LayerNorms compute in fp32
(eps 1e-6, Flax's), and cast to the activation dtype. The attention logits
and the attention-weighted sum are fp32 products of the activation-dtype
operands (``torch.matmul`` on fp32 copies: the JAX einsums'
``preferred_element_type=float32``), the softmax is fp32 and its output is
cast to the activation dtype before the second product, where the JAX
module casts. No Pallas kernel computes any of it in JAX, and no kernel
does here.

Parameter names follow the official ``network_swinir.py`` (``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.{norm1, attn.
qkv, attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1,
mlp.fc2}``, ``layers.{i}.conv``, ``norm``, ``conv_after_body``,
``conv_last``), so ``tools/convert_torch_swinir.py`` reads the
``state_dict``. The relative-position index and the shift mask are
derived in numpy, not stored, and kept on the device once per padded
shape, one cache for all blocks of a ``SwinIR``: the mask of a 256^2
image is 16 MB, and copying it from the host at every shifted block took
25 ms of a training step on an H100. Parameters stay fp32; ``dtype`` is
the activation dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.models.nafnet import _conv
from lowlight_image_enhancement_tpu_torch.utils.registry import ARCH_REGISTRY

# official SwinIR input normalisation for 3-channel input
_RGB_MEAN = (0.4488, 0.4371, 0.4040)
LN_EPS = 1e-6


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[N, H, W, C] -> [N * H/ws * W/ws, ws, ws, C]."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    n = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.reshape(n, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """Pairwise relative-position index table of a ws x ws window,
    ``[ws*ws, ws*ws]``."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The shifted-window attention mask, ``[num_windows, n, n]`` of 0 and
    -100 (the standard Swin construction), for a padded ``h x w``."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wss, :] = cnt
            cnt += 1
    mask_windows = np.reshape(
        img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
        .transpose(0, 1, 3, 2, 4, 5), (-1, ws * ws))
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def _linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``m`` applied in ``x``'s dtype (parameters stay fp32)."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.linear(x, m.weight.to(x.dtype), b)


def _layer_norm(m: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, cast to ``dtype``."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias,
                        m.eps).to(dtype)


def _nhwc_conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return _conv(m, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _Constants:
    """The derived index and mask tensors, per device and padded shape."""

    def __init__(self):
        self._cache: Dict[tuple, torch.Tensor] = {}

    def get(self, key: tuple, make, device: torch.device) -> torch.Tensor:
        key = key + (str(device),)
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(make()).to(device)
        return self._cache[key]


class WindowAttention(nn.Module):
    """Multi-head self-attention within a window, with the learned
    relative-position bias."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 consts: Optional[_Constants] = None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.consts = consts or _Constants()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            nn.init.trunc_normal_(
                torch.empty((2 * window_size - 1) ** 2, num_heads),
                std=0.02))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B_, n, C] with n = ws*ws; mask: [nW, n, n] or None."""
        b, n, c = x.shape
        dt = x.dtype
        heads = self.num_heads
        head_dim = c // heads
        qkv = _linear(self.qkv, x).reshape(b, n, 3, heads, head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        # fp32 logits of the activation-dtype operands
        attn = torch.matmul((q * head_dim ** -0.5).float(),
                            k.float().transpose(-1, -2))
        ws = self.window_size
        idx = self.consts.get(
            ("index", ws), lambda: relative_position_index(ws).reshape(-1),
            x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, heads)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b // nw, nw, heads, n, n) + mask[None, :, None]
            attn = attn.reshape(b, heads, n, n)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.matmul(attn.float(), v.float())
        out = out.transpose(1, 2).reshape(b, n, c).to(dt)
        return _linear(self.proj, out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x)))


class SwinBlock(nn.Module):
    """LN -> (shifted) window attention -> residual; LN -> MLP -> residual.
    The shift is dropped where ``min(H, W) <= window_size``."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 consts: Optional[_Constants] = None):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size, consts)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, H, W, C], H and W multiples of the window size."""
        _, h, w, c = x.shape
        ws = self.window_size
        dt = x.dtype
        shift = self.shift if min(h, w) > ws else 0
        y = _layer_norm(self.norm1, x, dt)
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self.attn.consts.get(
                ("mask", h, w, ws, shift),
                lambda: shift_attn_mask(h, w, ws, shift), x.device)
        wins = window_partition(y, ws).reshape(-1, ws * ws, c)
        wins = self.attn(wins, mask)
        y = window_reverse(wins.reshape(-1, ws, ws, c), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(_layer_norm(self.norm2, x, dt))


class _ResidualGroup(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: ``depth`` Swin blocks (every
    second one shifted by half a window), a 3x3 conv, the skip."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int = 8, mlp_ratio: float = 4.0,
                 consts: Optional[_Constants] = None):
        super().__init__()
        consts = consts or _Constants()
        self.residual_group = _ResidualGroup(
            SwinBlock(dim, num_heads, window_size,
                      shift=0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio=mlp_ratio, consts=consts)
            for i in range(depth))
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for blk in self.residual_group.blocks:
            y = blk(y)
        return x + _nhwc_conv(self.conv, y)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


@ARCH_REGISTRY.register(name="SwinIRRestoration")
@ARCH_REGISTRY.register()
class SwinIR(nn.Module):
    """SwinIR restoration network, ``upsampler=''`` path (official graph).

    Takes the official constructor surface so that the reference sweep
    YAML instantiates unchanged; ``img_size`` is accepted and unused (the
    forward is resolution-agnostic). ``forward`` raises
    ``NotImplementedError`` for ``upscale != 1``, an ``upsampler``,
    ``resi_connection != '1conv'``, ``ape`` or ``qkv_bias=False``, as the
    JAX module does. It takes fp32 ``[N, C, H, W]`` and returns fp32."""

    def __init__(self, img_channel: int = 3, embed_dim: int = 60,
                 depths: Sequence[int] = (4, 4, 4, 4),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 8, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32,
                 in_chans: Optional[int] = None, img_size: int = 64,
                 upscale: int = 1, img_range: float = 1.0,
                 upsampler: str = "", resi_connection: str = "1conv",
                 patch_norm: bool = True, ape: bool = False,
                 qkv_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.window_size = int(window_size)
        self.img_range = float(img_range)
        self.upscale, self.upsampler = upscale, upsampler
        self.resi_connection, self.ape, self.qkv_bias = (
            resi_connection, ape, qkv_bias)
        self.chans = int(in_chans if in_chans is not None else img_channel)
        self.conv_first = nn.Conv2d(self.chans, embed_dim, 3, padding=1)
        self.patch_embed = _PatchEmbed(embed_dim) if patch_norm else None
        consts = _Constants()
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, hd, self.window_size, mlp_ratio, consts)
            for d, hd in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_last = nn.Conv2d(embed_dim, self.chans, 3, padding=1)
        mean = _RGB_MEAN if self.chans == 3 else (0.0,) * self.chans
        self.register_buffer("mean", torch.tensor(mean).view(1, -1, 1, 1),
                             persistent=False)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if self.upscale != 1:
            raise NotImplementedError("SwinIR: only upscale=1 (restoration)")
        if self.upsampler != "":
            raise NotImplementedError("SwinIR: only upsampler='' supported")
        if self.resi_connection != "1conv":
            raise NotImplementedError("SwinIR: only resi_connection='1conv'")
        if self.ape or not self.qkv_bias:
            raise NotImplementedError("SwinIR: ape/qkv_bias=False unsupported")
        _, _, h, w = inp.shape
        ws, dt = self.window_size, self.dtype
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = inp.float()
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        x = (x - self.mean) * self.img_range
        shallow = _conv(self.conv_first, x.to(dt))
        y = shallow.permute(0, 2, 3, 1)                      # tokens, NHWC
        if self.patch_embed is not None:
            y = _layer_norm(self.patch_embed.norm, y, dt)
        for layer in self.layers:
            y = layer(y)
        y = _layer_norm(self.norm, y, dt).permute(0, 3, 1, 2)
        y = _conv(self.conv_after_body, y) + shallow
        out = _conv(self.conv_last, y) + x.to(dt)
        out = out.float() / self.img_range + self.mean
        return out[:, :, :h, :w]
