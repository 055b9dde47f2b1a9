"""TLC (Test-time Local Converter) windowed statistics (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/ops/tlc.py`` (reference
``local_arch.py:10-105``): at test time on large images the NAFBlock's
global average pool (SCA) sees other statistics than at training; TLC
replaces it with a windowed mean sized ~1.5x the training crop, computed
from an integral image (O(HW) whatever the window). Plain PyTorch: the
JAX package computes it with no Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def windowed_mean(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Per-pixel mean of NCHW ``x`` over a ``window`` = (kh, kw) centred on
    the pixel and clipped to the image, divided by the true count of the
    clipped window; the result in ``x``'s dtype.

    The integral image is float64: a window's sum is the difference of four
    prefix sums of the whole image, and in fp32 (the JAX function's type)
    that difference loses up to ~1e-2 of a small window's value to
    cancellation (1x1 windows of U(0, 1) data at 12x20).

    The window is not clamped to the image size: the clipping bounds it,
    and a window >= 2x the image gives the global mean at every pixel."""
    kh, kw = (int(k) for k in window)
    h, w = x.shape[-2:]
    # integral image with a leading zero row and column
    ii = F.pad(x.double().cumsum(-2).cumsum(-1), (1, 0, 1, 0))
    dev = x.device
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    r0 = (rows - kh // 2).clamp(0, h)
    r1 = (rows + (kh + 1) // 2).clamp(0, h)
    c0 = (cols - kw // 2).clamp(0, w)
    c1 = (cols + (kw + 1) // 2).clamp(0, w)

    def corner(r, c):
        return ii.index_select(-2, r).index_select(-1, c)

    total = corner(r1, c1) - corner(r0, c1) - corner(r1, c0) + corner(r0, c0)
    cnt = ((r1 - r0)[:, None] * (c1 - c0)[None, :]).double()
    return (total / cnt).to(x.dtype)


def tlc_window_from_train_size(train_size: Tuple[int, int],
                               ratio: float = 1.5) -> Tuple[int, int]:
    """The reference sizes TLC windows at ``ratio x train_size``."""
    return (int(train_size[0] * ratio), int(train_size[1] * ratio))
