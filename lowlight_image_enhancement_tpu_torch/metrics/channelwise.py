"""Per-channel PSNR / CPSNR / per-channel SSIM (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/metrics/channelwise.py``
(reference ``metrics/channelwise.py``). Every function takes NCHW
``[N, 3, H, W]`` images and returns a dict that carries its measurement
contract in-band (``meta={domain, data_range}``). The PSNRs accumulate in
float64 on the host; the SSIM runs on the tensors' device through
:func:`..metrics.linear.ssim_linear`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch.metrics.linear import ssim_linear
from lowlight_image_enhancement_tpu_torch.metrics.psnr import host_array

_CHANNELS = ("R", "G", "B")


def _validate(pred: torch.Tensor, target: torch.Tensor) -> None:
    if pred.shape != target.shape:
        raise ValueError(f"shape mismatch: {tuple(pred.shape)} vs "
                         f"{tuple(target.shape)}")
    if pred.dim() != 4 or pred.shape[1] != 3:
        raise ValueError(f"expected NCHW [N,3,H,W], got {tuple(pred.shape)}")
    if not (bool(torch.isfinite(pred).all())
            and bool(torch.isfinite(target).all())):
        raise ValueError("inputs must be finite")


def _psnr_db(mse: float, data_range: float) -> float:
    return (float("inf") if mse <= 1e-12
            else float(10.0 * np.log10(data_range ** 2 / mse)))


def _channel_mse(pred: torch.Tensor, target: torch.Tensor) -> list:
    p = host_array(pred, np.float64)
    t = host_array(target, np.float64)
    return [float(np.mean((p[:, c] - t[:, c]) ** 2)) for c in range(3)]


def rgb_psnr(pred: torch.Tensor, target: torch.Tensor, *,
             data_range: float = 1.0, domain: str = "linear"
             ) -> Dict[str, Any]:
    """Per-channel PSNR and their mean (reference ``channelwise.py:111-168``):
    ``{"R": dB, "G": dB, "B": dB, "mean": dB, "meta": {...}}``."""
    _validate(pred, target)
    vals = [_psnr_db(m, data_range) for m in _channel_mse(pred, target)]
    out: Dict[str, Any] = dict(zip(_CHANNELS, vals))
    out["mean"] = float(np.mean(vals))
    out["meta"] = {"domain": domain, "data_range": data_range}
    return out


def cpsnr_rgb(pred: torch.Tensor, target: torch.Tensor, *,
              data_range: float = 1.0, domain: str = "linear"
              ) -> Dict[str, Any]:
    """CPSNR: the mean of the channel MSEs, *then* the log (reference
    ``channelwise.py:170-222``), which differs from the mean of the
    per-channel PSNRs."""
    _validate(pred, target)
    channel_mse = _channel_mse(pred, target)
    return {
        "cpsnr": _psnr_db(float(np.mean(channel_mse)), data_range),
        "channel_mse": channel_mse,
        "meta": {"domain": domain, "data_range": data_range},
    }


def rgb_ssim(pred: torch.Tensor, target: torch.Tensor, *,
             data_range: float = 1.0, domain: str = "linear",
             **ssim_kwargs) -> Dict[str, Any]:
    """Per-channel SSIM through :func:`ssim_linear` (reference
    ``channelwise.py:224-303``)."""
    _validate(pred, target)
    scores = ssim_linear(pred, target, data_range=data_range,
                         per_channel=True, reduction="none",
                         **ssim_kwargs)  # [N, 3]
    per_channel = host_array(scores.mean(0))
    out: Dict[str, Any] = {name: float(per_channel[ci])
                           for ci, name in enumerate(_CHANNELS)}
    out["mean"] = float(np.mean(per_channel))
    out["meta"] = {"domain": domain, "data_range": data_range}
    return out
