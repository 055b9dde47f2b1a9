"""VGG19 feature trunk of the perceptual loss (NCHW).

Counterpart of ``VGG19Features`` / ``load_vgg19_features`` in
``lowlight_image_enhancement_tpu/models/vgg.py`` (reference
``NewBP_model/losses.py:32-69``: torchvision ``vgg19.features[:36]``,
conv1_1 .. relu5_4, frozen, ImageNet normalisation of sRGB [0,1] input).

Weights load from an ``.npz`` of ``conv{s}_{i}.weight`` (OIHW) /
``.bias`` entries, the format ``tools/convert_vgg_weights.py`` writes,
else the trunk gets a deterministic random initialisation from a seeded
``torch.Generator`` and reports ``pretrained=False``. The JAX package's
own random trunk can be carried over with
:func:`...weights.vgg_params_from_jax`.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.ops.image_ops import (
    MAXPOOL_IMPLS,
    max_pool_2x2,
)
from lowlight_image_enhancement_tpu_torch.ops.pool import relu_max_pool_2x2

logger = logging.getLogger(__name__)

# torchvision vgg19.features: (features, convs) per stage
VGG19_CFG: Tuple[Tuple[int, int], ...] = (
    (64, 2), (128, 2), (256, 4), (512, 4), (512, 4))

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def conv_names():
    """``conv{stage}_{i}`` names with their (in, out) channels."""
    out, cin = [], 3
    for stage, (feat, n_convs) in enumerate(VGG19_CFG, start=1):
        for i in range(1, n_convs + 1):
            out.append((f"conv{stage}_{i}", cin, feat))
            cin = feat
    return out


class VGG19Features(nn.Module):
    """VGG19 up to relu5_4 (no final pool), returning the requested
    ``relu{stage}_{i}`` activations. Parameters are fp32 and frozen;
    ``dtype`` is the trunk's compute type (bf16 under AMP).

    ``pool_impl`` selects how the four 2x2 max pools run; every value gives
    the same output and the same gradient:

    - ``None``: ``max_pool_2x2``'s own default (``$LLIE_MAXPOOL_IMPL``,
      else ``reduce_window``: the library pool under autograd);
    - ``reduce_window`` / ``kernel_bwd`` (``pallas_bwd``): passed to
      ``max_pool_2x2`` (``kernel_bwd``: library forward, kernel K8
      backward);
    - ``kernel_fused``: the stage-final ``relu(pool(x))`` sites run
      ``relu_max_pool_2x2`` (kernel K7 forward, K8 backward); a pool that
      follows a tapped relu runs ``kernel_bwd``."""

    def __init__(self, taps: Sequence[str] = ("relu5_4",),
                 dtype: torch.dtype = torch.float32,
                 pool_impl: Optional[str] = None):
        super().__init__()
        self.taps = tuple(taps)
        self.dtype = dtype
        if pool_impl is not None and pool_impl not in (*MAXPOOL_IMPLS,
                                                       "kernel_fused"):
            raise ValueError(f"unknown pool_impl {pool_impl!r}")
        self.pool_impl = pool_impl
        known = {n.replace("conv", "relu") for n, _, _ in conv_names()}
        unknown = set(self.taps) - known
        if unknown:
            raise ValueError(f"unknown VGG taps requested: {sorted(unknown)}")
        for name, cin, cout in conv_names():
            self.add_module(name, nn.Conv2d(cin, cout, 3, padding=1))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        shape = (1, 3, 1, 1)
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype,
                            device=x.device).view(shape)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype,
                           device=x.device).view(shape)
        x = ((x.clamp(0.0, 1.0) - mean) / std).to(self.dtype)
        outputs: Dict[str, torch.Tensor] = {}
        fused = self.pool_impl == "kernel_fused"
        impl = "kernel_bwd" if fused else self.pool_impl
        for stage, (_, n_convs) in enumerate(VGG19_CFG, start=1):
            for i in range(1, n_convs + 1):
                conv = getattr(self, f"conv{stage}_{i}")
                x = F.conv2d(x, conv.weight.to(self.dtype),
                             conv.bias.to(self.dtype), padding=1)
                name = f"relu{stage}_{i}"
                # the stage-final relu commutes with the 2x2 max pool, and
                # so do their gradients (first-max routing, relu'(0) = 0):
                # pool first, as the JAX trunk does, unless it is a tap
                if (i == n_convs and stage < len(VGG19_CFG)
                        and name not in self.taps):
                    x = (relu_max_pool_2x2(x) if fused
                         else F.relu(max_pool_2x2(x, impl)))
                    continue
                x = F.relu(x)
                if name in self.taps:
                    outputs[name] = x
                if i == n_convs and stage < len(VGG19_CFG):
                    x = max_pool_2x2(x, impl)
        return outputs


def _random_init_(module: VGG19Features, generator: torch.Generator) -> None:
    """Normal weights with std ``1/sqrt(fan_in)`` (the scale of Flax's
    LeCun-normal default), zero biases, drawn on the CPU from
    ``generator``."""
    with torch.no_grad():
        for name, _, _ in conv_names():
            conv = getattr(module, name)
            fan_in = conv.weight[0].numel()
            w = torch.randn(conv.weight.shape, generator=generator)
            conv.weight.copy_(w / fan_in ** 0.5)
            conv.bias.zero_()


def load_vgg19_features(taps: Sequence[str] = ("relu5_4",),
                        weights_path: Optional[str] = None,
                        dtype: torch.dtype = torch.float32,
                        generator: Optional[torch.Generator] = None,
                        pool_impl: Optional[str] = None):
    """``(module, pretrained)`` on the CPU (move it with ``.to``);
    ``pool_impl`` as in :class:`VGG19Features`.

    Weight search order: ``weights_path`` -> ``$LLIE_VGG19_NPZ`` ->
    ``weights/vgg19_features.npz`` beside this package's modules -> a
    deterministic random trunk from ``generator`` (seed 0 when None)."""
    module = VGG19Features(taps=taps, dtype=dtype, pool_impl=pool_impl)
    candidates = [
        weights_path,
        os.environ.get("LLIE_VGG19_NPZ"),
        str(Path(__file__).resolve().parent.parent / "weights"
            / "vgg19_features.npz"),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            npz = dict(np.load(cand))
            sd = module.state_dict()
            for key in sd:
                if key in npz:
                    sd[key] = torch.from_numpy(
                        np.asarray(npz[key], np.float32))
            module.load_state_dict(sd)
            logger.info("VGG19 weights loaded from %s", cand)
            return module, True
    logger.warning(
        "VGG19 pretrained weights not found: using deterministic random "
        "features (set LLIE_VGG19_NPZ or run tools/convert_vgg_weights.py).")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    _random_init_(module, generator)
    return module, False
