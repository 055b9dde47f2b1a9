"""LPIPS perceptual distance (NCHW): a backbone's features and linear heads.

Counterpart of ``lowlight_image_enhancement_tpu/models/lpips.py`` (the
reference's ``lpips`` dependency, LPIPS v0.1, nets ``alex`` and ``vgg``):
inputs in [-1, 1] shifted and scaled, the trunk's five ReLU taps, each
unit-normalised over channels (eps 1e-10 added to the norm), squared
differences weighted by non-negative 1x1 heads (``abs`` of ``lin{i}``),
a spatial mean (or bilinear maps with ``spatial``), summed over the taps.
The trunk's pools are ``F.max_pool2d``, as ``nn.max_pool`` is in JAX.

:func:`load_lpips` reads the converted ``.npz`` the JAX loader reads
(``tools/convert_lpips_weights.py``: ``trunk.conv*.weight`` OIHW,
``trunk.conv*.bias``, ``lin{i}.weight``) from ``weights_path``, then
``$LLIE_LPIPS_NPZ``, then ``weights/lpips_{net}.npz`` beside this
package's modules; otherwise the network gets a deterministic random
initialisation from a seeded ``torch.Generator`` and reports
``pretrained=False`` (the distance is then a valid perceptual functional,
but not comparable with published LPIPS numbers). The JAX package's own
random network can be carried over with
:func:`...weights.lpips_params_from_jax`.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.ops.image_ops import (
    resize_bilinear,
)

logger = logging.getLogger(__name__)

# LPIPS v0.1 shift and scale of the [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# (name, in, out, kernel, stride, padding) of the AlexNet trunk, and the
# VGG16 trunk's (features, convs) per stage
_ALEX = (("conv1", 3, 64, 11, 4, 2), ("conv2", 64, 192, 5, 1, 2),
         ("conv3", 192, 384, 3, 1, 1), ("conv4", 384, 256, 3, 1, 1),
         ("conv5", 256, 256, 3, 1, 1))
_VGG16 = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

N_CHANNELS = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
}


class _AlexFeatures(nn.Module):
    """AlexNet trunk: the five conv activations after their ReLU."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s, p in _ALEX:
            self.add_module(name, nn.Conv2d(cin, cout, k, stride=s,
                                            padding=p))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, (name, *_) in enumerate(_ALEX):
            x = F.relu(getattr(self, name)(x))
            taps.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return taps


class _VGGFeatures(nn.Module):
    """VGG16 trunk: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage, (feat, n) in enumerate(_VGG16, start=1):
            for ci in range(1, n + 1):
                self.add_module(f"conv{stage}_{ci}",
                                nn.Conv2d(cin, feat, 3, padding=1))
                cin = feat

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for stage, (_, n) in enumerate(_VGG16, start=1):
            for ci in range(1, n + 1):
                x = F.relu(getattr(self, f"conv{stage}_{ci}")(x))
            taps.append(x)
            if stage < len(_VGG16):
                x = F.max_pool2d(x, 2, 2)
        return taps


class _Head(nn.Module):
    """A tap's 1x1 linear head, ``weight`` ``[1, C, 1, 1]`` (the layout of
    the ``lpips`` package's ``lin{i}.model.1.weight``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, channels, 1, 1))


class LPIPSNet(nn.Module):
    """The LPIPS distance network. ``forward(x, y)`` takes NCHW inputs
    already in [-1, 1] (cast to the network's dtype: fp32 unless the
    module was converted, e.g. by ``.double()``) and returns per-image
    distances ``[N]``, or per-pixel maps ``[N, H, W]`` when ``spatial``.
    Its parameters are frozen."""

    def __init__(self, net: str = "alex", spatial: bool = False):
        super().__init__()
        if net not in N_CHANNELS:
            raise ValueError(f"net must be 'alex' or 'vgg', got {net!r}")
        self.net = net
        self.spatial = spatial
        self.trunk = _AlexFeatures() if net == "alex" else _VGGFeatures()
        for i, c in enumerate(N_CHANNELS[net]):
            self.add_module(f"lin{i}", _Head(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x, y = x.to(self.shift.dtype), y.to(self.shift.dtype)
        fx = self.trunk((x - self.shift) / self.scale)
        fy = self.trunk((y - self.shift) / self.scale)

        def unit(z):
            return z / (torch.sqrt((z * z).sum(1, keepdim=True)) + 1e-10)

        total = None
        for i, (ax, ay) in enumerate(zip(fx, fy)):
            w = getattr(self, f"lin{i}").weight.abs()
            dmap = ((unit(ax) - unit(ay)) ** 2 * w).sum(1)  # [N, h, w]
            if self.spatial:
                dmap = resize_bilinear(dmap[:, None], x.shape[2:])[:, 0]
            else:
                dmap = dmap.mean((1, 2))
            total = dmap if total is None else total + dmap
        return total


def _random_init_(module: LPIPSNet, generator: torch.Generator) -> None:
    """Conv weights from N(0, 1/fan_in) (the scale of Flax's LeCun-normal
    default), zero biases, heads from U[0, 0.1) (the JAX heads' init),
    drawn on the CPU from ``generator``."""
    with torch.no_grad():
        for m in module.trunk.children():
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / fan_in ** 0.5)
            m.bias.zero_()
        for i in range(len(N_CHANNELS[module.net])):
            head = getattr(module, f"lin{i}").weight
            head.copy_(torch.rand(head.shape, generator=generator) * 0.1)


def _load_npz(module: LPIPSNet, npz: dict) -> None:
    """``trunk.conv*.weight/bias`` and ``lin{i}.weight`` of ``npz`` into
    ``module`` (every other key is ignored, as the JAX loader does)."""
    sd = module.state_dict()
    for key, val in npz.items():
        if key in sd:
            sd[key] = torch.from_numpy(np.asarray(val, np.float32).reshape(
                sd[key].shape))
    module.load_state_dict(sd)


def load_lpips(net: str = "alex", spatial: bool = False,
               weights_path: Optional[str] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[LPIPSNet, bool]:
    """``(module, pretrained)`` on the CPU (move it with ``.to``). Weight
    search order: ``weights_path`` -> ``$LLIE_LPIPS_NPZ`` ->
    ``weights/lpips_{net}.npz`` beside this package's modules -> a
    deterministic random network from ``generator`` (seed 0 when None)."""
    module = LPIPSNet(net=net, spatial=spatial)
    candidates = [
        weights_path,
        os.environ.get("LLIE_LPIPS_NPZ"),
        str(Path(__file__).resolve().parent.parent / "weights"
            / f"lpips_{net}.npz"),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            _load_npz(module, dict(np.load(cand)))
            logger.info("LPIPS(%s) weights loaded from %s", net, cand)
            return module, True
    logger.warning(
        "LPIPS(%s) pretrained weights not found: deterministic random init "
        "(set LLIE_LPIPS_NPZ or run tools/convert_lpips_weights.py).", net)
    _random_init_(module, generator or torch.Generator().manual_seed(0))
    return module, False
