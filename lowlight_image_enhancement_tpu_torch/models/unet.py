"""U-Net SID baseline (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/models/unet.py`` (reference
``archs/unet_sid_arch.py:11-118``): ``inc`` DoubleConv, per-stage max-pool
+ DoubleConv downs, a ``bottom`` DoubleConv at the lowest scale, ups that
upsample, pad to the skip's size and concatenate ``[skip, up]`` before a
DoubleConv, and a 1x1 ``outc``.

- ``bilinear=True`` (the config's choice) upsamples by
  ``ops/image_ops.py:resize_bilinear`` (x2) and a 1x1 conv that halves the
  channels -- the JAX package's repair of the reference's broken default
  graph; ``bilinear=False`` runs a ConvTranspose 2x2 / stride 2, the
  reference's working graph.
- ``norm='group'`` puts a GroupNorm(min(8, C)) (eps 1e-6, fp32 statistics,
  as Flax's) after each conv; the default ``'none'`` is the reference's.
- The downs call ``max_pool_2x2(x, impl=None)``: ``$LLIE_MAXPOOL_IMPL``
  ``=kernel_bwd`` (JAX spelling ``pallas_bwd``) routes their backward
  through kernel K8, as the JAX env var routes it through its Pallas
  kernel.

Parameter names follow the reference torch module (``inc.block.{0,2}``,
``down_layers.{i}.block.1.block.{0,2}``, ``bottom.block.{0,2}``,
``up_layers.{i}.up``, ``up_layers.{i}.conv.block.{0,2}``, ``outc``; with
GroupNorm the convs sit at ``block.{0,3}`` and the norms at
``block.{1,4}``), so ``tools/convert_torch_unet.py`` reads the
``bilinear=False``, ``norm='none'`` state_dict. Parameters stay fp32;
``dtype`` is the activation dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.models.nafnet import _conv
from lowlight_image_enhancement_tpu_torch.ops.image_ops import (
    max_pool_2x2,
    resize_bilinear,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import ARCH_REGISTRY


class DoubleConv(nn.Module):
    """Two conv3x3(+bias) [+ GroupNorm] + ReLU stages (reference
    ``DoubleConv``, ``unet_sid_arch.py:11-24``)."""

    def __init__(self, in_ch: int, features: int, norm: str = "none"):
        super().__init__()
        if norm not in ("none", "group"):
            raise ValueError(f"norm must be 'none' or 'group', got {norm!r}")
        layers = []
        for cin in (in_ch, features):
            layers.append(nn.Conv2d(cin, features, 3, padding=1))
            if norm == "group":
                layers.append(nn.GroupNorm(min(8, features), features,
                                           eps=1e-6))
            layers.append(nn.ReLU())
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.block:
            if isinstance(layer, nn.Conv2d):
                x = _conv(layer, x)
            elif isinstance(layer, nn.GroupNorm):
                x = F.group_norm(x.float(), layer.num_groups, layer.weight,
                                 layer.bias, layer.eps).to(x.dtype)
            else:
                x = F.relu(x)
        return x


class _MaxPool(nn.Module):
    """``max_pool_2x2`` with the implementation ``$LLIE_MAXPOOL_IMPL``
    names at call time."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2x2(x, impl=None)


class _Up(nn.Module):
    """Upsample (``up``) -> pad to the skip -> ``[skip, up]`` -> ``conv``."""

    def __init__(self, in_ch: int, out_ch: int, bilinear: bool, norm: str):
        super().__init__()
        self.bilinear = bilinear
        self.up = (nn.Conv2d(in_ch, out_ch, 1) if bilinear
                   else nn.ConvTranspose2d(in_ch, out_ch, 2, stride=2))
        self.conv = DoubleConv(2 * out_ch, out_ch, norm)

    def forward(self, h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.bilinear:
            h = resize_bilinear(h, (2 * h.shape[2], 2 * h.shape[3]))
            h = _conv(self.up, h)
        else:
            b = None if self.up.bias is None else self.up.bias.to(h.dtype)
            h = F.conv_transpose2d(h, self.up.weight.to(h.dtype), b,
                                   stride=2)
        dh = skip.shape[2] - h.shape[2]
        dw = skip.shape[3] - h.shape[3]
        if dh or dw:
            h = F.pad(h, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([skip, h], dim=1))


@ARCH_REGISTRY.register(name="UNetSIDModel")
@ARCH_REGISTRY.register()
class UNetSID(nn.Module):
    """Encoder-decoder U-Net with skip concatenations (reference
    ``UNetSID``, ``unet_sid_arch.py:66-114``) on NCHW input; ``forward``
    returns fp32. ``base_channels`` is accepted for the config surface; the
    channel plan is ``depths``."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 base_channels: int = 32,
                 depths: Sequence[int] = (32, 64, 128, 256),
                 bilinear: bool = True, norm: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = tuple(int(c) for c in depths)
        self.dtype = dtype
        self.inc = DoubleConv(in_channels, chans[0], norm)
        self.down_layers = nn.ModuleList()
        for cin, c in zip(chans[:-1], chans[1:]):
            down = nn.Module()
            down.block = nn.Sequential(_MaxPool(), DoubleConv(cin, c, norm))
            self.down_layers.append(down)
        self.bottom = DoubleConv(chans[-1], chans[-1], norm)
        self.up_layers = nn.ModuleList(
            _Up(cin, c, bilinear, norm)
            for cin, c in zip(chans[::-1][:-1], chans[::-1][1:]))
        self.outc = nn.Conv2d(chans[0], out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.inc(x.to(self.dtype))
        skips = []
        for down in self.down_layers:
            skips.append(h)
            h = down.block(h)
        h = self.bottom(h)
        for up, skip in zip(self.up_layers, skips[::-1]):
            h = up(h, skip)
        return _conv(self.outc, h).float()
