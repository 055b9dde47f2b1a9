"""InceptionV3 pool3 feature extractor for FID (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/models/inception.py``: the
extractor the reference's FID is defined over, pytorch-fid's
``InceptionV3([3])`` (``NAFNet_base/basicsr/metrics/fid.py:14-25``), whose
output is the 2048-d global mean of ``Mixed_7c`` ("pool3").

- ``fid_variant=True`` (default, what published FID numbers use): every
  in-block average pool excludes the padding (``count_include_pad=False``)
  and ``Mixed_7c``'s pool branch is a max pool (pytorch-fid's
  ``FIDInceptionE_2``); ``False``: torchvision's ``inception_v3`` (average
  pools with ``count_include_pad=True``).
- :class:`BasicConv`: a conv without bias, a frozen BatchNorm (its
  running statistics, eps 1e-3) and a ReLU; the torch state-dict names of
  torchvision and pytorch-fid (``Mixed_5b.branch1x1.conv.weight``,
  ``....bn.running_mean``), so a checkpoint converted by
  ``tools/convert_inception_weights.py`` loads as it is.
- ``resize_input`` resizes to 299^2 with
  :func:`..ops.image_ops.resize_bilinear` (``jax.image.resize``'s
  arithmetic: antialiased where it shrinks; pytorch-fid does not
  antialias, the port follows the JAX package).

:func:`load_inception_v3` searches ``weights_path``, ``$LLIE_INCEPTION_NPZ``
and ``weights/inception_v3_fid.npz`` beside this package's modules, else
draws a deterministic random trunk from a seeded ``torch.Generator`` and
reports ``pretrained=False`` (FID callers refuse it unless told
otherwise: ``metrics/fid.py``). The JAX package's own trunk can be
carried over with :func:`...weights.inception_params_from_jax`.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lowlight_image_enhancement_tpu_torch.ops.image_ops import (
    resize_bilinear,
)

logger = logging.getLogger(__name__)

BN_EPS = 1e-3

Pad = Tuple[int, int]


class BasicConv(nn.Module):
    """Conv (no bias) + frozen BatchNorm (eps 1e-3) + ReLU (torchvision
    ``BasicConv2d``)."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_s1(x: torch.Tensor, count_include_pad: bool):
    """3x3 / stride 1 / pad 1 average pool with the chosen divisor."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int,
                 count_include_pad: bool):
        super().__init__()
        self.cip = count_include_pad
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_s1(x, self.cip))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, count_include_pad: bool):
        super().__init__()
        self.cip = count_include_pad
        p17, p71 = (0, 3), (3, 0)
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=p17)
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=p71)
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=p17)
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=p17)
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_s1(x, self.cip))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_mode`` "avg" (``Mixed_7b``) or "max" (``Mixed_7c`` of the FID
    variant, pytorch-fid ``FIDInceptionE_2``)."""

    def __init__(self, cin: int, pool_mode: str, count_include_pad: bool):
        super().__init__()
        self.pool_mode = pool_mode
        self.cip = count_include_pad
        p13, p31 = (0, 1), (1, 0)
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=p13)
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=p31)
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=p13)
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=p31)
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (F.max_pool2d(x, 3, 1, 1) if self.pool_mode == "max"
              else _avg_pool_3x3_s1(x, self.cip))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Pool3(nn.Module):
    """InceptionV3 up to the 2048-d pool3 features of NCHW ``x``:
    ``resize_input`` (to 299^2), ``normalize_input`` (maps [0, 1] to
    [-1, 1]; off by default: the inputs are expected in [-1, 1], as
    ``basicsr/metrics/fid.py:14-25`` configures pytorch-fid). Frozen and
    always in eval mode (BatchNorm on its running statistics); fp32."""

    def __init__(self, fid_variant: bool = True, resize_input: bool = True,
                 normalize_input: bool = False):
        super().__init__()
        self.fid_variant = fid_variant
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        cip = not fid_variant
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, cip)
        self.Mixed_5c = InceptionA(256, 64, cip)
        self.Mixed_5d = InceptionA(288, 64, cip)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, cip)
        self.Mixed_6c = InceptionC(768, 160, cip)
        self.Mixed_6d = InceptionC(768, 160, cip)
        self.Mixed_6e = InceptionC(768, 192, cip)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", cip)
        self.Mixed_7c = InceptionE(2048, "max" if fid_variant else "avg",
                                   cip)
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True) -> "InceptionV3Pool3":
        """Stays in eval mode: the BatchNorms are frozen."""
        return super().train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.resize_input and tuple(x.shape[2:]) != (299, 299):
            x = resize_bilinear(x, (299, 299))
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean((2, 3))  # pool3


def _random_init_(module: InceptionV3Pool3,
                  generator: torch.Generator) -> None:
    """Conv weights from N(0, 1/fan_in) (the scale of Flax's LeCun-normal
    default) drawn on the CPU from ``generator``; BatchNorm at identity
    (scale 1, bias 0, mean 0, variance 1), as the JAX init has it."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BasicConv):
                fan_in = m.conv.weight[0].numel()
                m.conv.weight.copy_(torch.randn(
                    m.conv.weight.shape, generator=generator) / fan_in ** 0.5)
                m.bn.reset_parameters()


def load_inception_v3(weights_path: Optional[str] = None,
                      fid_variant: bool = True, resize_input: bool = True,
                      normalize_input: bool = False,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[InceptionV3Pool3, bool]:
    """``(module, pretrained)`` on the CPU (move it with ``.to``). Weight
    search order: ``weights_path`` -> ``$LLIE_INCEPTION_NPZ`` ->
    ``weights/inception_v3_fid.npz`` beside this package's modules -> a
    deterministic random trunk from ``generator`` (seed 0 when None). A
    weight file must hold every conv and BatchNorm array of the trunk."""
    module = InceptionV3Pool3(fid_variant=fid_variant,
                              resize_input=resize_input,
                              normalize_input=normalize_input)
    candidates = [
        weights_path,
        os.environ.get("LLIE_INCEPTION_NPZ"),
        str(Path(__file__).resolve().parent.parent / "weights"
            / "inception_v3_fid.npz"),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            npz = dict(np.load(cand))
            sd = module.state_dict()
            for key in sd:
                if key.endswith("num_batches_tracked"):
                    continue
                if key not in npz:
                    raise KeyError(f"missing {key} in {cand}")
                sd[key] = torch.from_numpy(np.asarray(npz[key], np.float32))
            module.load_state_dict(sd)
            logger.info("InceptionV3 weights loaded from %s", cand)
            return module, True
    logger.warning(
        "InceptionV3 pretrained weights not found: random init (set "
        "$LLIE_INCEPTION_NPZ or run tools/convert_inception_weights.py). "
        "FID computed with a random trunk is NOT comparable to published "
        "numbers.")
    _random_init_(module, generator or torch.Generator().manual_seed(0))
    return module, False
