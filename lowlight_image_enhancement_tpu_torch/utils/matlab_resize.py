"""MATLAB-convention ``imresize`` (bicubic, antialiased).

The port's own copy of ``lowlight_image_enhancement_tpu/utils/
matlab_resize.py``.

Rebuild of the reference's inherited ``basicsr/utils/matlab_functions.py``
(``cubic:12-26``, ``imresize:94-176``): MATLAB's bicubic kernel (a = -0.5) with kernel-width scaling
(antialiasing) for downsampling, symmetric edge replication, separable
passes — the convention behind most published SR/restoration PSNR tables.

Pure NumPy (host-side preprocessing/metric utility).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB bicubic kernel, a = -0.5."""
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0)
            * ((ax > 1) & (ax <= 2)))


def _weights_indices(in_len: int, out_len: int, scale: float):
    """Per-output-pixel contribution weights + source indices (MATLAB's
    ``contributions``)."""
    kernel_width = 4.0
    if scale < 1.0:  # antialias: widen the kernel
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1  # 0-based
    dist = u[:, None] - (indices + 1)
    if scale < 1.0:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # clamp indices symmetrically (edge replication per MATLAB aux space)
    indices = np.clip(indices, 0, in_len - 1).astype(np.int64)
    # drop all-zero-weight columns
    nz = np.any(weights != 0, axis=0)
    return weights[:, nz], indices[:, nz]


def imresize(
    img: np.ndarray,
    scale: Union[float, None] = None,
    out_shape: Union[Tuple[int, int], None] = None,
) -> np.ndarray:
    """Resize HW or HWC float arrays with MATLAB bicubic semantics.

    Provide either ``scale`` or ``out_shape`` (H, W).
    """
    img = np.asarray(img, dtype=np.float64)
    squeeze = False
    if img.ndim == 2:
        img = img[:, :, None]
        squeeze = True
    h, w, c = img.shape
    if scale is not None:
        out_h, out_w = int(np.ceil(h * scale)), int(np.ceil(w * scale))
        scale_h = scale_w = float(scale)
    elif out_shape is not None:
        out_h, out_w = out_shape
        scale_h, scale_w = out_h / h, out_w / w
    else:
        raise ValueError("provide scale or out_shape")

    # vertical pass
    weights, indices = _weights_indices(h, out_h, scale_h)
    out = np.einsum("ok,okwc->owc", weights, img[indices])  # [out_h, w, c]
    # horizontal pass
    weights, indices = _weights_indices(w, out_w, scale_w)
    out = np.einsum("ok,hokc->hoc", weights,
                    out[:, indices])  # [out_h, out_w, c]
    return out[..., 0] if squeeze else out
