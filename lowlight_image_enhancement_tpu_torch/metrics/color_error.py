"""CIEDE2000 evaluation metrics: maps, summaries, edge-masked statistics
(NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/metrics/color_error.py``
(reference ``metrics/color_error.py``), on the port's ``ops/color.py``:

- :func:`deltaE2000_map` -- per-pixel Sharma-2005 DeltaE00 between sRGB
  [0,1] NCHW images via D65/2deg Lab (``color_error.py:104-210``);
- :func:`deltaE2000_summary` -- mean and percentiles
  (``color_error.py:269-293``);
- :func:`edge_deltaE2000` -- Sobel magnitude of the target's Lab-L, a
  per-image quantile mask, mean/percentiles over the edge pixels
  (``color_error.py:304-344``).

The maps are computed in fp32 on the tensors' device; the means,
quantiles and percentiles on the host in numpy, as in the JAX version. A
D50 whitepoint request warns (no chromatic adaptation), as the reference
does (``color_error.py:86-97``).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Sequence

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch.ops.color import (
    deltaE2000_rgb,
    rgb_to_lab,
    sobel_magnitude,
)


def _validate_rgb(pred: torch.Tensor, target: torch.Tensor) -> None:
    if pred.shape != target.shape:
        raise ValueError(f"shape mismatch: {tuple(pred.shape)} vs "
                         f"{tuple(target.shape)}")
    if pred.dim() != 4 or pred.shape[1] != 3:
        raise ValueError(f"expected NCHW [N,3,H,W], got {tuple(pred.shape)}")
    if not (bool(torch.isfinite(pred).all())
            and bool(torch.isfinite(target).all())):
        raise ValueError("inputs must be finite")


def _check_whitepoint(whitepoint: str) -> None:
    if whitepoint.upper() == "D50":
        warnings.warn(
            "D50 whitepoint requested but no chromatic adaptation is "
            "implemented; computing under D65 (same as reference).",
            stacklevel=3)
    elif whitepoint.upper() != "D65":
        raise ValueError(f"unsupported whitepoint {whitepoint!r}")


def deltaE2000_map(pred: torch.Tensor, target: torch.Tensor, *,
                   whitepoint: str = "D65") -> torch.Tensor:
    """Per-pixel DeltaE00 map ``[N, H, W]`` (fp32) between sRGB [0,1] NCHW
    images."""
    _validate_rgb(pred, target)
    _check_whitepoint(whitepoint)
    return deltaE2000_rgb(pred.float(), target.float())


def deltaE2000_summary(pred: torch.Tensor, target: torch.Tensor, *,
                       percentiles: Sequence[float] = (95.0,),
                       whitepoint: str = "D65") -> Dict[str, Any]:
    """Mean and percentiles of the DeltaE00 map over all pixels:
    ``{"mean": float, "p95": float, ..., "meta": {...}}``."""
    dmap = deltaE2000_map(pred, target, whitepoint=whitepoint).cpu().numpy()
    out: Dict[str, Any] = {"mean": float(dmap.mean())}
    for q in percentiles:
        out[f"p{q:g}"] = float(np.percentile(dmap, q))
    out["meta"] = {"whitepoint": "D65", "observer": "2deg"}
    return out


def edge_deltaE2000(pred: torch.Tensor, target: torch.Tensor, *,
                    edge_quantile: float = 0.85,
                    percentiles: Sequence[float] = (95.0,),
                    whitepoint: str = "D65") -> Dict[str, Any]:
    """DeltaE00 statistics restricted to the edge pixels of the target:
    the Sobel magnitude of its Lab-L at or above the per-image
    ``edge_quantile`` (a flat image falls back to all pixels)."""
    _validate_rgb(pred, target)
    if not 0.0 < edge_quantile < 1.0:
        raise ValueError("edge_quantile must be in (0, 1)")
    _check_whitepoint(whitepoint)

    dmap = deltaE2000_rgb(pred.float(), target.float()).cpu().numpy()
    mag = sobel_magnitude(rgb_to_lab(target.float())[:, 0]).cpu().numpy()
    means, pcts = [], {f"p{q:g}": [] for q in percentiles}
    for i in range(dmap.shape[0]):
        mask = mag[i] >= np.quantile(mag[i], edge_quantile)
        vals = dmap[i][mask]
        if vals.size == 0:
            vals = dmap[i].ravel()
        means.append(float(vals.mean()))
        for q in percentiles:
            pcts[f"p{q:g}"].append(float(np.percentile(vals, q)))
    out: Dict[str, Any] = {"mean": float(np.mean(means))}
    for key, vlist in pcts.items():
        out[key] = float(np.mean(vlist))
    out["meta"] = {"whitepoint": "D65", "observer": "2deg",
                   "edge_quantile": edge_quantile,
                   "edge_source": "sobel(Lab-L of target)"}
    return out
