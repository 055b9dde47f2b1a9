"""Generic architecture building blocks (reference ``arch_util.py``), NCHW.

Counterpart of ``lowlight_image_enhancement_tpu/models/blocks.py``:

- :class:`ResidualBlockNoBN` -- conv3x3 -> ReLU -> conv3x3 + identity, with
  the reference's optional 0.1-scaled initialisation;
- :func:`make_layer` -- N identical blocks in an ``nn.Sequential``;
- :class:`UpsamplePixelShuffle` -- x2^n / x3 upsampling by 3x3 conv +
  pixel shuffle (reference ``Upsample``);
- :func:`default_init_scale` -- the "scale=0.1" Kaiming initialiser of
  EDSR-style residual trunks.

Parameters stay fp32; ``dtype`` is the activation dtype.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.models.nafnet import (
    _conv,
    pixel_shuffle,
)


def default_init_scale(scale: float = 0.1) -> Callable[[torch.Tensor], None]:
    """An in-place initialiser: Kaiming-normal (fan in, ReLU gain)
    multiplied by ``scale`` (reference ``default_init_weights(scale=0.1)``)."""

    @torch.no_grad()
    def init(weight: torch.Tensor) -> None:
        nn.init.kaiming_normal_(weight)
        weight.mul_(scale)

    return init


class ResidualBlockNoBN(nn.Module):
    """conv3x3 -> ReLU -> conv3x3, identity residual scaled by
    ``res_scale``, no batch norm. ``small_init`` draws both kernels from
    :func:`default_init_scale` (0.1), else plain Kaiming-normal; biases 0."""

    def __init__(self, features: int = 64, res_scale: float = 1.0,
                 small_init: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res_scale = float(res_scale)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        init = default_init_scale(0.1 if small_init else 1.0)
        for conv in (self.conv1, self.conv2):
            init(conv.weight)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(self.conv2, F.relu(_conv(self.conv1, x.to(self.dtype))))
        return x + y * self.res_scale


def make_layer(block_cls, num_blocks: int, **block_kwargs) -> nn.Sequential:
    """``num_blocks`` instances of ``block_cls(**block_kwargs)`` applied in
    order (reference ``make_layer``)."""
    return nn.Sequential(*[block_cls(**block_kwargs)
                           for _ in range(num_blocks)])


class UpsamplePixelShuffle(nn.Module):
    """x ``scale`` upsampling of a ``features``-channel map by conv +
    pixel-shuffle stages: ``log2(scale)`` x2 stages (``conv{i}``: features
    -> 4 features) for a power of two, one x3 stage (9 features) for 3,
    nothing for 1; any other scale raises ``ValueError``."""

    def __init__(self, scale: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if scale > 1 and scale & (scale - 1) == 0:
            stages = [(f"conv{i}", 4, 2) for i in range(int(math.log2(scale)))]
        elif scale == 3:
            stages = [("conv0", 9, 3)]
        elif scale == 1:
            stages = []
        else:
            raise ValueError(
                f"scale {scale} unsupported (powers of 2 and 3 only)")
        self.shuffles = [r for _, _, r in stages]
        for name, mult, _ in stages:
            self.add_module(name, nn.Conv2d(features, mult * features, 3,
                                            padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, r in enumerate(self.shuffles):
            x = pixel_shuffle(_conv(getattr(self, f"conv{i}"), x), r)
        return x
