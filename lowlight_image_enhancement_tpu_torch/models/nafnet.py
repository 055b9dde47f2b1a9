"""NAFNet restoration backbone in PyTorch (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/models/nafnet.py``:

- :class:`NAFBlock` -- LN -> 1x1 conv (C->2C) -> 3x3 depthwise ->
  SimpleGate -> SCA (global mean + 1x1) -> 1x1 conv, then LN -> 1x1 (C->2C)
  -> SimpleGate -> 1x1; residual scales ``beta``/``gamma`` zero-initialised.
  With ``fused=True`` (the default) a block with ``dw_expand == 2`` runs
  :class:`...ops.nafblock.NAFBlockFunction`: kernels K1+K2 forward and
  K3+K4 backward on CUDA, their plain versions on CPU -- the counterpart
  of the JAX ``fused_blocks=True``. With ``fused=False``, and for any
  other ``dw_expand`` (which the JAX package leaves unfused too), it runs
  the eager module graph under autograd, the counterpart of the JAX
  unfused ``NAFBlock``. ``tlc_window`` (the TLC windowed SCA mean,
  :func:`...ops.tlc.windowed_mean`) and ``dropout_rate`` (dropout after
  ``conv3`` and ``conv5``, masks drawn from :attr:`NAFBlock.generator`)
  run the module graph too, as the JAX ``_fused_hw`` leaves such blocks
  unfused.
- :class:`UShapedNet` (shared with ``models/baseline.py``) and
  :class:`NAFNet` -- 3x3 intro, encoder stacks with 2x2 stride-2 downs,
  middle stack, decoder stacks with (1x1 no-bias conv + PixelShuffle(2))
  ups and skip-adds, 3x3 ending, global input residual; zero-pads to a
  multiple of ``2**len(enc_blk_nums)`` and crops afterwards;
  :func:`nafnet_local` (registered ``NAFNetLocal``) is a ``NAFNet`` whose
  SCA means are TLC windows of ``tlc_ratio x train_size``.

Parameter names are those of the reference torch NAFNet (``intro``,
``encoders.{s}.{b}.*``, ``downs.{s}``, ``middle_blks.{b}``, ``ups.{s}.0``,
``decoders.{s}.{b}``, ``ending``, ``sca.1``), so
``tools/convert_torch_nafnet.py`` reads this module's ``state_dict``.
Parameters stay fp32; ``dtype`` is the activation dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.ops.layernorm import (
    LayerNorm2d,
    layer_norm_2d,
)
from lowlight_image_enhancement_tpu_torch.ops.nafblock import (
    nafblock_fwd,
    pack_params,
)
from lowlight_image_enhancement_tpu_torch.ops.tlc import (
    tlc_window_from_train_size,
    windowed_mean,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import ARCH_REGISTRY


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    """Channel-chunk(2) elementwise product (reference ``SimpleGate``)."""
    x1, x2 = x.chunk(2, dim=1)
    return x1 * x2


class SimpleGate(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return simple_gate(x)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NCHW pixel shuffle, torch channel order ``(c, r1, r2)``."""
    return F.pixel_shuffle(x, r)


def _conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` applied in ``x``'s dtype (parameters stay fp32)."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), b, stride=m.stride,
                    padding=m.padding, groups=m.groups)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout as Flax ``nn.Dropout`` computes it: keep where a
    uniform draw from ``generator`` is below ``1 - rate``, scaled by
    ``1 / (1 - rate)``."""
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=generator.device)
    mask = draw.to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


class NAFBlock(nn.Module):
    """The NAFNet block (reference ``NAFNet_arch.py:27-80``).

    ``tlc_window`` = (kh, kw) replaces the SCA global mean by the TLC
    windowed mean; ``dropout_rate > 0`` drops after ``conv3`` and ``conv5``
    in training mode, with masks from :attr:`generator` (set by the caller,
    as ``NAFSSR.generator``). Either option runs :meth:`forward_eager`."""

    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2,
                 fused: bool = True, eps: float = 1e-6,
                 dropout_rate: float = 0.0,
                 tlc_window: Optional[Tuple[int, int]] = None):
        super().__init__()
        dw = c * dw_expand
        ffn = c * ffn_expand
        self.dw_expand = dw_expand
        self.fused = fused
        self.eps = eps
        self.dropout_rate = float(dropout_rate)
        self.tlc_window = None if tlc_window is None else tuple(tlc_window)
        self.generator: Optional[torch.Generator] = None
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = nn.Conv2d(dw // 2, c, 1)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 nn.Conv2d(dw // 2, dw // 2, 1))
        self.conv4 = nn.Conv2d(c, ffn, 1)
        self.conv5 = nn.Conv2d(ffn // 2, c, 1)
        self.norm1 = LayerNorm2d(c, eps)
        self.norm2 = LayerNorm2d(c, eps)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def packed(self):
        """Kernel-ready parameter views (:func:`...ops.nafblock.pack_params`)."""
        return pack_params(
            self.norm1.weight, self.norm1.bias,
            self.conv1.weight, self.conv1.bias,
            self.conv2.weight, self.conv2.bias,
            self.sca[1].weight, self.sca[1].bias,
            self.conv3.weight, self.conv3.bias,
            self.norm2.weight, self.norm2.bias,
            self.conv4.weight, self.conv4.bias,
            self.conv5.weight, self.conv5.bias,
            self.beta, self.gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.fused and self.dw_expand == 2 and self.tlc_window is None
                and self.dropout_rate == 0.0):
            # NAFBlockFunction with or without grad (forward K1+K2 only
            # under no_grad). A block with dw_expand != 2, TLC or dropout
            # runs the module graph on every device, as the JAX _fused_hw
            # leaves it unfused.
            n, c, h, w = x.shape
            y = nafblock_fwd(x.contiguous().view(n, c, h * w), self.packed(),
                             (h, w), self.eps)
            return y.view(n, c, h, w)
        return self.forward_eager(x)

    def forward_eager(self, x: torch.Tensor) -> torch.Tensor:
        """The module graph in ``x``'s dtype (LN statistics in fp32)."""
        dt = x.dtype
        y = layer_norm_2d(x, self.norm1.weight, self.norm1.bias, self.eps)
        y = _conv(self.conv1, y)
        y = _conv(self.conv2, y)
        y = simple_gate(y)
        if self.tlc_window is not None:
            att = windowed_mean(y, self.tlc_window)
        else:
            att = y.float().mean((2, 3), keepdim=True).to(dt)
        y = y * _conv(self.sca[1], att)
        y = self._dropout(_conv(self.conv3, y))
        z = x + y * self.beta.to(dt)
        y = layer_norm_2d(z, self.norm2.weight, self.norm2.bias, self.eps)
        y = simple_gate(_conv(self.conv4, y))
        y = self._dropout(_conv(self.conv5, y))
        return z + y * self.gamma.to(dt)

    def _dropout(self, y: torch.Tensor) -> torch.Tensor:
        if self.dropout_rate == 0.0 or not self.training:
            return y
        return dropout(y, self.dropout_rate, self.generator)


class UShapedNet(nn.Module):
    """The U-shaped macro-structure NAFNet and Baseline share (reference
    ``NAFNet_arch.py:83-162``) around ``block(channels) -> nn.Module``.
    ``forward`` takes fp32 ``[N, img_channel, H, W]`` and returns fp32."""

    def __init__(self, block: Callable[[int], nn.Module], img_channel: int,
                 width: int, middle_blk_num: int,
                 enc_blk_nums: Sequence[int], dec_blk_nums: Sequence[int],
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.intro = nn.Conv2d(img_channel, width, 3, padding=1)
        self.ending = nn.Conv2d(width, img_channel, 3, padding=1)
        self.encoders = nn.ModuleList()
        self.decoders = nn.ModuleList()
        self.downs = nn.ModuleList()
        self.ups = nn.ModuleList()
        chan = width
        for num in enc_blk_nums:
            self.encoders.append(
                nn.Sequential(*[block(chan) for _ in range(num)]))
            self.downs.append(nn.Conv2d(chan, 2 * chan, 2, 2))
            chan *= 2
        self.middle_blks = nn.Sequential(
            *[block(chan) for _ in range(middle_blk_num)])
        for num in dec_blk_nums:
            self.ups.append(nn.Sequential(
                nn.Conv2d(chan, chan * 2, 1, bias=False), nn.PixelShuffle(2)))
            chan //= 2
            self.decoders.append(
                nn.Sequential(*[block(chan) for _ in range(num)]))
        self.padder_size = 2 ** len(enc_blk_nums)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        _, _, h, w = inp.shape
        inp = self._pad_to_multiple(inp).to(self.dtype)  # also the residual
        x = _conv(self.intro, inp)
        skips = []
        for enc, down in zip(self.encoders, self.downs):
            x = enc(x)
            skips.append(x)
            x = _conv(down, x)
        x = self.middle_blks(x)
        for dec, up, skip in zip(self.decoders, self.ups, skips[::-1]):
            x = pixel_shuffle(_conv(up[0], x), 2)
            x = dec(x + skip)
        x = _conv(self.ending, x) + inp
        return x[:, :, :h, :w].float()

    def _pad_to_multiple(self, x: torch.Tensor) -> torch.Tensor:
        m = self.padder_size
        ph = (m - x.shape[2] % m) % m
        pw = (m - x.shape[3] % m) % m
        if ph == 0 and pw == 0:
            return x
        return F.pad(x, (0, pw, 0, ph))


@ARCH_REGISTRY.register()
class NAFNet(UShapedNet):
    """U-shaped NAFNet (reference ``NAFNet_arch.py:83-162``) on NCHW input.

    SID config: ``width=32, enc_blk_nums=(2,2,4,8), middle_blk_num=12,
    dec_blk_nums=(2,2,2,2)`` -- 36 NAFBlocks over channels 32 to 512.
    ``forward`` takes fp32 ``[N, img_channel, H, W]`` and returns fp32.
    """

    def __init__(self, img_channel: int = 3, width: int = 16,
                 middle_blk_num: int = 1, enc_blk_nums: Sequence[int] = (),
                 dec_blk_nums: Sequence[int] = (), dw_expand: int = 2,
                 ffn_expand: int = 2, dtype: torch.dtype = torch.float32,
                 fused_blocks: bool = True, dropout_rate: float = 0.0,
                 tlc_window: Optional[Tuple[int, int]] = None):
        super().__init__(
            lambda ch: NAFBlock(ch, dw_expand, ffn_expand, fused_blocks,
                                dropout_rate=dropout_rate,
                                tlc_window=tlc_window),
            img_channel, width, middle_blk_num, enc_blk_nums, dec_blk_nums,
            dtype)

    def blocks(self):
        return [m for m in self.modules() if isinstance(m, NAFBlock)]

    @property
    def generator(self) -> Optional[torch.Generator]:
        """The dropout masks' ``torch.Generator``, shared by every block
        (needed in training mode when ``dropout_rate > 0``)."""
        blocks = self.blocks()
        return blocks[0].generator if blocks else None

    @generator.setter
    def generator(self, gen: Optional[torch.Generator]) -> None:
        for blk in self.blocks():
            blk.generator = gen


@ARCH_REGISTRY.register(name="NAFNetLocal")
def nafnet_local(*, train_size: Sequence[int] = (256, 256),
                 tlc_ratio: float = 1.5, **kwargs) -> NAFNet:
    """Test-time Local Converter variant (reference ``NAFNetLocal`` +
    ``Local_Base.convert``): NAFNet's parameters, SCA means over windows of
    ``tlc_ratio x train_size``."""
    window = tlc_window_from_train_size(tuple(train_size), tlc_ratio)
    return NAFNet(tlc_window=window, **kwargs)
