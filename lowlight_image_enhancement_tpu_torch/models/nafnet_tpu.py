"""NAFNetTPU: the space-to-depth NAFNet variant (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/models/nafnet_tpu.py``: a
2x2 (``s2d_factor``) pixel unshuffle at the stem folds space into channels
(3 -> 12 channels at half resolution), a ``trunk`` :class:`NAFNet` of
``img_channel * r**2`` channels runs there, and a pixel shuffle at the head
restores full resolution. The input is zero-padded to a multiple of
``r * 2**len(enc_blk_nums)`` first and the output cropped back. A network
of its own, not a reference NAFNet: its checkpoints do not interchange.

Every NAFBlock of the trunk runs ``NAFBlockFunction`` (K1/K2 forward,
K3/K4 backward on CUDA), like every fused block. Parameter names:
``trunk.*`` (a :class:`NAFNet`). The JAX default activation dtype is
bf16, and so is this one's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.models.nafnet import (
    NAFNet,
    pixel_shuffle,
)
from lowlight_image_enhancement_tpu_torch.ops.image_ops import pixel_unshuffle
from lowlight_image_enhancement_tpu_torch.utils.registry import ARCH_REGISTRY


@ARCH_REGISTRY.register()
class NAFNetTPU(nn.Module):
    """Space-to-depth NAFNet. ``width`` is the trunk width after
    space-to-depth: ``2 * W`` matches the capacity profile of a standard
    ``NAFNet(width=W)``. ``forward`` takes fp32 ``[N, img_channel, H, W]``
    and returns fp32."""

    def __init__(self, img_channel: int = 3, s2d_factor: int = 2,
                 width: int = 64, middle_blk_num: int = 12,
                 enc_blk_nums: Sequence[int] = (2, 2, 4, 8),
                 dec_blk_nums: Sequence[int] = (2, 2, 2, 2),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.s2d_factor = int(s2d_factor)
        self.multiple = self.s2d_factor * 2 ** len(enc_blk_nums)
        r2 = self.s2d_factor ** 2
        self.trunk = NAFNet(img_channel=img_channel * r2, width=width,
                            middle_blk_num=middle_blk_num,
                            enc_blk_nums=tuple(enc_blk_nums),
                            dec_blk_nums=tuple(dec_blk_nums), dtype=dtype)

    def blocks(self):
        return self.trunk.blocks()

    @property
    def dtype(self) -> torch.dtype:
        """The activation dtype (the trunk's)."""
        return self.trunk.dtype

    @dtype.setter
    def dtype(self, dt: torch.dtype) -> None:
        self.trunk.dtype = dt

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        r, m = self.s2d_factor, self.multiple
        _, _, h, w = inp.shape
        x = F.pad(inp, (0, (m - w % m) % m, 0, (m - h % m) % m))
        y = self.trunk(pixel_unshuffle(x, r))   # its residual is the s2d input
        return pixel_shuffle(y, r)[:, :, :h, :w].float()
