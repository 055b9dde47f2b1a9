"""Linear-domain PSNR / SSIM with explicit data-range contracts (NCHW).

Counterpart of ``psnr_linear`` and ``ssim_linear`` in
``lowlight_image_enhancement_tpu/metrics/linear.py`` (reference
``metrics/linear.py:82-324``), accumulating in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch.ops.psf import depthwise_conv

_REDUCTIONS = {"mean", "sum", "none"}
_SSIM_PAD = ("reflect", "replicate", "zero")


def _validate_pair(pred: torch.Tensor, target: torch.Tensor) -> None:
    if pred.shape != target.shape:
        raise ValueError(f"shape mismatch: pred {tuple(pred.shape)} vs "
                         f"target {tuple(target.shape)}")
    if pred.dim() != 4:
        raise ValueError(f"expected NCHW [N,C,H,W], got ndim={pred.dim()}")


def _reduce(scores: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return scores
    return scores.sum() if reduction == "sum" else scores.mean()


def psnr_linear(pred: torch.Tensor, target: torch.Tensor, *,
                data_range: float = 1.0, reduction: str = "mean",
                clamp: bool = False, eps: float = 1e-12) -> torch.Tensor:
    """Per-image PSNR in dB over all pixels and channels; an image whose
    MSE is at most ``eps`` reports ``inf``."""
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be one of {_REDUCTIONS}")
    if data_range <= 0:
        raise ValueError("data_range must be positive")
    _validate_pair(pred, target)
    p, t = pred.float(), target.float()
    if clamp:
        p = p.clamp(0.0, data_range)
        t = t.clamp(0.0, data_range)
    mse = ((p - t) ** 2).mean((1, 2, 3))
    psnr = 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=eps))
    psnr = torch.where(mse <= eps, torch.full_like(psnr, float("inf")), psnr)
    return _reduce(psnr, reduction)


@functools.lru_cache(maxsize=32)
def _window_np(kernel_size: int, sigma: float, uniform: bool) -> np.ndarray:
    """1-D window summing to 1 (Gaussian or uniform), float32."""
    if uniform:
        w = np.ones((kernel_size,), dtype=np.float64)
    else:
        ax = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
        w = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    return (w / w.sum()).astype(np.float32)


def ssim_linear(pred: torch.Tensor, target: torch.Tensor, *,
                data_range: float = 1.0, kernel_size: int = 11,
                sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
                gaussian: bool = True, padding: str = "reflect",
                reduction: str = "mean",
                per_channel: bool = False) -> torch.Tensor:
    """From-scratch SSIM: separable window blur (vertical then horizontal
    pass, SAME ``padding``), variances clamped at 0, map averaged over
    space (and channels unless ``per_channel``)."""
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be one of {_REDUCTIONS}")
    if padding not in _SSIM_PAD:
        raise ValueError(f"padding must be one of {sorted(_SSIM_PAD)}")
    if kernel_size % 2 != 1 or kernel_size < 3:
        raise ValueError("kernel_size must be an odd integer >= 3")
    _validate_pair(pred, target)
    if min(pred.shape[2], pred.shape[3]) < kernel_size:
        raise ValueError(f"image spatial dims {tuple(pred.shape[2:])} smaller "
                         f"than SSIM window {kernel_size}")
    x, y = pred.float(), target.float()
    win = torch.from_numpy(_window_np(kernel_size, sigma, not gaussian)).to(
        x.device)

    def blur(z):
        z = depthwise_conv(z, win[None, :, None], padding=padding)
        return depthwise_conv(z, win[None, None, :], padding=padding)

    mu_x, mu_y = blur(x), blur(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x2 = (blur(x * x) - mu_x2).clamp(min=0.0)
    sigma_y2 = (blur(y * y) - mu_y2).clamp(min=0.0)
    sigma_xy = blur(x * y) - mu_xy
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ssim_map = ((2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2))
    scores = ssim_map.mean((2, 3)) if per_channel else ssim_map.mean((1, 2, 3))
    return _reduce(scores, reduction)
