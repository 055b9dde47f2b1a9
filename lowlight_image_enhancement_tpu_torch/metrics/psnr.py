"""Batch PSNR accumulated in float64 on the host.

Counterpart of ``lowlight_image_enhancement_tpu/metrics/psnr.py``
(reference ``metrics/psnr.py:18-67``): ``calculate_psnr(img_true,
img_pred, data_range)`` -> one float in dB over the whole batch, ``inf``
when the MSE is at most 1e-12. Any layout: the two inputs only need the
same shape. :func:`host_array` is the one conversion of a tensor (on any
device) or array to numpy that the port's host-side metrics use.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

ArrayLike = Union[torch.Tensor, np.ndarray]


def host_array(x: ArrayLike, dtype: Optional[np.dtype] = None
               ) -> np.ndarray:
    """``x`` as a numpy array on the host (a tensor is detached and copied
    from its device; bf16 goes through fp32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.cpu().numpy()
    return np.asarray(x, dtype=dtype)


def calculate_psnr(img_true: ArrayLike, img_pred: ArrayLike,
                   data_range: float = 1.0) -> float:
    """Whole-batch PSNR in dB, accumulated in float64 (the per-image,
    on-device PSNR is :func:`..metrics.linear.psnr_linear`)."""
    if data_range <= 0:
        raise ValueError("data_range must be positive")
    a = host_array(img_true, np.float64)
    b = host_array(img_pred, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
        raise ValueError("inputs must be finite")
    mse = float(np.mean((a - b) ** 2))
    if mse <= 1e-12:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / mse))
