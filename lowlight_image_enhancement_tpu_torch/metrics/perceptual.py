"""Functional LPIPS (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/metrics/perceptual.py``
(reference ``metrics/perceptual.py:95-208``): ``lpips_srgb(pred, target,
net=..., spatial=...)`` on sRGB [0, 1] batches -- strict NCHW and
finiteness checks, at least 16x16, gray replicated to 3 channels,
optional clamp, [0, 1] -> [-1, 1], the model cached per (net, spatial,
device), per-pixel maps with ``spatial``.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch.metrics.lpips_metric import (
    lpips_model,
)
from lowlight_image_enhancement_tpu_torch.metrics.psnr import host_array


@torch.no_grad()
def lpips_srgb(pred: torch.Tensor, target: torch.Tensor, *,
               net: str = "alex", spatial: bool = False,
               clamp_input: bool = True, device: Any = "cuda") -> np.ndarray:
    """LPIPS of sRGB [0, 1] NCHW batches on ``device``: per-image scores
    ``[N]``, or per-pixel maps ``[N, H, W]`` with ``spatial``."""
    model, _ = lpips_model(net, spatial=spatial, device=device)
    dev = next(model.parameters()).device
    p = torch.as_tensor(pred).to(dev, torch.float32)
    t = torch.as_tensor(target).to(dev, torch.float32)
    if p.dim() != 4 or t.dim() != 4:
        raise ValueError("expected NCHW [N,C,H,W]")
    if p.shape != t.shape:
        raise ValueError(f"shape mismatch {tuple(p.shape)} vs "
                         f"{tuple(t.shape)}")
    if not (bool(torch.isfinite(p).all()) and bool(torch.isfinite(t).all())):
        raise ValueError("inputs must be finite")
    if min(p.shape[2], p.shape[3]) < 16:
        raise ValueError("LPIPS requires images >= 16x16")
    if p.shape[1] == 1:
        p, t = p.repeat(1, 3, 1, 1), t.repeat(1, 3, 1, 1)
    if clamp_input:
        p, t = p.clamp(0.0, 1.0), t.clamp(0.0, 1.0)
    elif float(p.min()) < 0 or float(p.max()) > 1:
        warnings.warn("lpips_srgb inputs outside [0,1] without clamping",
                      stacklevel=2)
    return host_array(model(p * 2.0 - 1.0, t * 2.0 - 1.0))
