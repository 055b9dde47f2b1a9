"""NAFSSR: the stereo super-resolution NAFNet variant in PyTorch (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/models/nafssr.py``
(reference ``archs/NAFSSR_arch.py:25-170``): one weight-shared NAFBlock
trunk applied to both stereo views, a SCAM (stereo cross-attention module)
fusing the views after each block, per-sample stochastic depth on the
block's residual, and a pixel-shuffle upsampler over a bilinear global
residual.

Input ``[N, 2 * img_channel, H, W]``: the two views concatenated on the
channel axis (left first); output ``[N, 2 * img_channel, s H, s W]``.

Kernels: every :class:`NAFBlockSR` runs the port's fused ``NAFBlock`` once
per view (K1/K2 forward, K3/K4 backward on CUDA), and the two
``LayerNorm2d`` of each SCAM run K5/K6. SCAM's two attention products and
softmaxes are ``torch.matmul`` / ``softmax`` on fp32 operands, as the JAX
module leaves them to XLA with fp32 accumulation.

Parameter names: ``intro``, ``body.{i}.blk.*`` (a ``NAFBlock``),
``body.{i}.scam.{norm_l,norm_r,l_proj1,r_proj1,l_proj2,r_proj2,beta,
gamma}``, ``up``. Parameters stay fp32; ``dtype`` is the activation dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.models.nafnet import (
    NAFBlock,
    _conv,
    pixel_shuffle,
)
from lowlight_image_enhancement_tpu_torch.ops.layernorm import LayerNorm2d
from lowlight_image_enhancement_tpu_torch.utils.registry import ARCH_REGISTRY


class SCAM(nn.Module):
    """Stereo cross-attention (reference ``NAFSSR_arch.py``): scaled
    dot-product attention along the width (epipolar) axis between the two
    views, with zero-initialised output scales."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = c ** -0.5
        self.norm_l = LayerNorm2d(c)
        self.norm_r = LayerNorm2d(c)
        self.l_proj1 = nn.Conv2d(c, c, 1)
        self.r_proj1 = nn.Conv2d(c, c, 1)
        self.l_proj2 = nn.Conv2d(c, c, 1)
        self.r_proj2 = nn.Conv2d(c, c, 1)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, xl: torch.Tensor, xr: torch.Tensor):
        dt = xl.dtype
        rows = lambda t: t.permute(0, 2, 3, 1).float()      # [N, H, W, C]
        ql = rows(_conv(self.l_proj1, self.norm_l(xl)))
        qr = rows(_conv(self.r_proj1, self.norm_r(xr)))
        vl = rows(_conv(self.l_proj2, xl))
        vr = rows(_conv(self.r_proj2, xr))
        # attn[n, h, w, v] = <ql[n, h, w], qr[n, h, v]> * scale, in fp32
        attn = torch.matmul(ql, qr.transpose(-1, -2)) * self.scale
        f_r2l = torch.matmul(torch.softmax(attn, -1), vr)
        f_l2r = torch.matmul(torch.softmax(attn, -2).transpose(-1, -2), vl)
        back = lambda t: t.permute(0, 3, 1, 2).to(dt)
        return (xl + back(f_r2l) * self.beta.to(dt),
                xr + back(f_l2r) * self.gamma.to(dt))


class DropPath(nn.Module):
    """Stochastic depth on a residual branch, one Bernoulli draw per sample
    from an explicit ``torch.Generator``: ``delta * mask / keep``. The
    identity when ``rate == 0`` or the module is in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"drop-path rate must be in [0, 1), got {rate}")
        self.rate = float(rate)

    def forward(self, delta: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return delta
        if generator is None:
            raise ValueError("DropPath in training mode needs a "
                             "torch.Generator")
        keep = 1.0 - self.rate
        draw = torch.rand(delta.shape[0], generator=generator,
                          device=generator.device)
        mask = (draw < keep).to(device=delta.device, dtype=delta.dtype)
        return delta * mask.view(-1, 1, 1, 1) / keep


class NAFBlockSR(nn.Module):
    """One NAFBlock applied to both views, drop-path on each view's
    residual (a draw of its own per view), then the optional SCAM."""

    def __init__(self, c: int, fusion: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.blk = NAFBlock(c)
        self.drop_path = DropPath(drop_path)
        self.scam = SCAM(c) if fusion else None

    def forward(self, xl: torch.Tensor, xr: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        xl = xl + self.drop_path(self.blk(xl) - xl, generator)
        xr = xr + self.drop_path(self.blk(xr) - xr, generator)
        if self.scam is not None:
            xl, xr = self.scam(xl, xr)
        return xl, xr


@ARCH_REGISTRY.register()
class NAFSSR(nn.Module):
    """Stereo SR network (reference ``NAFSSR``): shared intro conv, a stack
    of :class:`NAFBlockSR`, pixel-shuffle up, global bilinear residual.

    ``configs/stereo_nafssr.yml``: ``up_scale=2, width=48, num_blks=16,
    drop_path_rate=0.1``, fusion in every block. In training mode with
    ``drop_path_rate > 0`` the masks come from :attr:`generator`, a
    ``torch.Generator`` the caller sets; eval mode draws nothing."""

    def __init__(self, up_scale: int = 2, width: int = 48, num_blks: int = 16,
                 img_channel: int = 3, fusion_from: int = -1,
                 fusion_to: int = 1000, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.up_scale = up_scale
        self.img_channel = img_channel
        self.generator: Optional[torch.Generator] = None
        self.intro = nn.Conv2d(img_channel, width, 3, padding=1)
        self.body = nn.ModuleList(
            NAFBlockSR(width, fusion=fusion_from <= i <= fusion_to,
                       drop_path=drop_path_rate) for i in range(num_blks))
        self.up = nn.Conv2d(width, img_channel * up_scale ** 2, 3, padding=1)

    def blocks(self):
        return [m.blk for m in self.body]

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if inp.shape[1] != 2 * self.img_channel:
            raise ValueError(f"NAFSSR takes [N, {2 * self.img_channel}, H, W]"
                             f" (two views on the channel axis), got "
                             f"{tuple(inp.shape)}")
        views = inp.split(self.img_channel, dim=1)
        fl, fr = (_conv(self.intro, v.to(self.dtype)) for v in views)
        for blk in self.body:
            fl, fr = blk(fl, fr, self.generator)
        outs = []
        for f, v in zip((fl, fr), views):
            base = F.interpolate(v, scale_factor=self.up_scale,
                                 mode="bilinear", align_corners=False)
            outs.append(pixel_shuffle(_conv(self.up, f), self.up_scale)
                        + base.to(self.dtype))
        return torch.cat(outs, dim=1).float()
