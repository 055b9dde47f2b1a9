"""The NAFNet paper's "Baseline" architecture in PyTorch (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/models/baseline.py``
(reference ``archs/Baseline_arch.py:22-202``): the ablation baseline that
NAFNet simplifies -- the same U-shaped macro-structure, but the blocks use
exact GELU activations and squeeze-and-excitation channel attention
(reduction 2) instead of SimpleGate / SCA.

Every ``norm1`` / ``norm2`` is a :class:`...ops.layernorm.LayerNorm2d`, so
on CUDA each runs kernel K5 forward and K6 backward (two of each per
block); the rest of the block is cuDNN / elementwise PyTorch in the
activation ``dtype``. Parameter names are those of the reference torch
Baseline (``intro``, ``encoders.{s}.{b}.*``, ``downs.{s}``,
``middle_blks.{b}``, ``ups.{s}.0``, ``decoders.{s}.{b}``, ``ending``, and
in a block ``conv1..conv5``, ``se.1``, ``se.3``, ``norm1``, ``norm2``,
``beta``, ``gamma``), so ``tools/convert_torch_baseline.py`` reads this
module's ``state_dict``. Parameters stay fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.models.nafnet import (
    UShapedNet,
    _conv,
)
from lowlight_image_enhancement_tpu_torch.ops.layernorm import LayerNorm2d
from lowlight_image_enhancement_tpu_torch.utils.registry import ARCH_REGISTRY


class BaselineBlock(nn.Module):
    """LN -> 1x1 (c->dw) -> 3x3 depthwise -> GELU -> channel attention ->
    1x1, then LN -> 1x1 (c->ffn) -> GELU -> 1x1; residual scales ``beta`` /
    ``gamma`` zero-initialised (reference ``Baseline_arch.py:22-79``)."""

    def __init__(self, c: int, dw_expand: int = 1, ffn_expand: int = 2,
                 eps: float = 1e-6):
        super().__init__()
        dw = c * dw_expand
        ffn = c * ffn_expand
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = nn.Conv2d(dw, c, 1)
        # squeeze-and-excitation, reduction 2: mean -> 1x1 -> ReLU -> 1x1
        # -> sigmoid (the parameters sit at indices 1 and 3)
        self.se = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dw, dw // 2, 1), nn.ReLU(),
            nn.Conv2d(dw // 2, dw, 1), nn.Sigmoid())
        self.conv4 = nn.Conv2d(c, ffn, 1)
        self.conv5 = nn.Conv2d(ffn, c, 1)
        self.norm1 = LayerNorm2d(c, eps)
        self.norm2 = LayerNorm2d(c, eps)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def _attention(self, y: torch.Tensor) -> torch.Tensor:
        a = y.float().mean((2, 3), keepdim=True).to(y.dtype)
        a = F.relu(_conv(self.se[1], a))
        return y * torch.sigmoid(_conv(self.se[3], a))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = _conv(self.conv1, self.norm1(x))
        y = F.gelu(_conv(self.conv2, y))
        y = _conv(self.conv3, self._attention(y))
        z = x + y * self.beta.to(dt)
        y = F.gelu(_conv(self.conv4, self.norm2(z)))
        y = _conv(self.conv5, y)
        return z + y * self.gamma.to(dt)


@ARCH_REGISTRY.register()
class Baseline(UShapedNet):
    """U-shaped Baseline network (reference ``Baseline`` class) on NCHW
    input. The paper's ``Baseline-width32`` configuration is ``width=32,
    enc_blk_nums=(2,2,4,8), middle_blk_num=12, dec_blk_nums=(2,2,2,2),
    dw_expand=1, ffn_expand=2``: 36 blocks, 72 LayerNorms."""

    def __init__(self, img_channel: int = 3, width: int = 16,
                 middle_blk_num: int = 1, enc_blk_nums: Sequence[int] = (),
                 dec_blk_nums: Sequence[int] = (), dw_expand: int = 1,
                 ffn_expand: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__(
            lambda ch: BaselineBlock(ch, dw_expand, ffn_expand),
            img_channel, width, middle_blk_num, enc_blk_nums, dec_blk_nums,
            dtype)
