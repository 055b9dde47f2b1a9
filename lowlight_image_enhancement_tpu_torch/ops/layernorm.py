"""Per-pixel channel LayerNorm ("LayerNorm2d") forward on NCHW.

Counterpart of ``lowlight_image_enhancement_tpu/ops/layernorm.py:
layer_norm_2d``: normalisation over the channel axis at every spatial
location, statistics in fp32 (mean, then the centred variance), affine
weight/bias per channel, result in the input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6, dim: int = 1) -> torch.Tensor:
    """LayerNorm over ``dim`` (the channel axis) with fp32 statistics."""
    xf = x.float()
    mu = xf.mean(dim, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float().view(shape) + bias.float().view(shape)
    return y.to(x.dtype)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm with learnable affine, on ``[N, C, H, W]``."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias, self.eps)
