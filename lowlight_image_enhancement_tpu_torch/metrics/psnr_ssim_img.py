"""uint8-image PSNR/SSIM with MATLAB conventions (stock BasicSR metrics).

A copy of ``lowlight_image_enhancement_tpu/metrics/psnr_ssim_img.py``
(reference ``basicsr/metrics/psnr_ssim.py``: ``calculate_psnr:16-78``,
``_ssim:92-168``, ``calculate_ssim:251-336``; ``rgb2ycbcr`` from
``basicsr/utils/matlab_functions.py:179-205``), host numpy in float64 as
there: the ``use_image: true`` validation path's metrics on one HWC
image pair (uint8 range or [0, 1]; a tensor is moved to the host), with
``crop_border`` and the MATLAB Y channel (``test_y_channel``); SSIM uses
the 11x11 Gaussian window on the **valid** (unpadded) region, as MATLAB's
``ssim_index`` does.
"""

from __future__ import annotations

import numpy as np

from lowlight_image_enhancement_tpu_torch.metrics.psnr import (
    ArrayLike,
    host_array,
)


def rgb2ycbcr(img: ArrayLike, y_only: bool = False) -> np.ndarray:
    """MATLAB ``rgb2ycbcr`` of a float [0,1] HWC image, returned in [0,1]:
    the ITU-R BT.601 studio-swing transform with offsets 16/128 on the 255
    scale."""
    img = host_array(img, np.float64)
    if y_only:
        out = (np.dot(img, [65.481, 128.553, 24.966]) + 16.0) / 255.0
        return out[..., None]
    mat = np.array(
        [[65.481, -37.797, 112.0],
         [128.553, -74.203, -93.786],
         [24.966, 112.0, -18.214]]
    )
    return (img @ mat + [16.0, 128.0, 128.0]) / 255.0


def _prep(img: ArrayLike, crop_border: int, test_y_channel: bool
          ) -> np.ndarray:
    img = host_array(img, np.float64)
    if img.ndim == 2:
        img = img[..., None]
    if img.max() > 2.0:  # uint8-range input
        img = img / 255.0
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel and img.shape[-1] == 3:
        img = rgb2ycbcr(img, y_only=True)
    return img * 255.0


def calculate_psnr_img(img1: ArrayLike, img2: ArrayLike,
                       crop_border: int = 0,
                       test_y_channel: bool = False) -> float:
    """Image PSNR in dB on the 255 scale (one HWC image pair)."""
    a = _prep(img1, crop_border, test_y_channel)
    b = _prep(img2, crop_border, test_y_channel)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    mse = float(np.mean((a - b) ** 2))
    if mse <= 1e-12:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2_valid(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """2-D correlation over the 'valid' region (MATLAB ``filter2``)."""
    from numpy.lib.stride_tricks import sliding_window_view

    views = sliding_window_view(img, win.shape)  # [H-k+1, W-k+1, k, k]
    return np.einsum("ijkl,kl->ij", views, win)


def _ssim_single(a: np.ndarray, b: np.ndarray) -> float:
    """SSIM of one channel on the 255 scale (MATLAB ``ssim_index``)."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    win = _gaussian_window()
    mu1 = _filter2_valid(a, win)
    mu2 = _filter2_valid(b, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2_valid(a * a, win) - mu1_sq
    s2 = _filter2_valid(b * b, win) - mu2_sq
    s12 = _filter2_valid(a * b, win) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def calculate_ssim_img(img1: ArrayLike, img2: ArrayLike,
                       crop_border: int = 0,
                       test_y_channel: bool = False) -> float:
    """Image SSIM averaged over channels, MATLAB valid-window convention."""
    a = _prep(img1, crop_border, test_y_channel)
    b = _prep(img2, crop_border, test_y_channel)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.mean([
        _ssim_single(a[..., c], b[..., c]) for c in range(a.shape[-1])
    ]))
