"""SSIM evaluator: data-range inference, align policies, streaming (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/metrics/ssim.py``
(reference ``metrics/ssim.py:49-569``) on the port's
:func:`..metrics.linear.ssim_linear`, on the tensors' device:

- the data range inferred among {1.0, 2.0 (= [-1, 1]), 255.0}
  (``ssim.py:62-71``);
- the window clipped to the image, kept odd (``ssim.py:74-89``);
- BT.601 luma mode (``ssim.py:116-127``);
- resize / center-crop alignment of mismatched shapes (``ssim.py:130-167``;
  the resize is :func:`..ops.image_ops.resize_bilinear`, antialiased as
  ``jax.image.resize`` is);
- per-image scores, mean/std/p50/p95 and the configuration echoed in the
  result dict (``ssim.py:313-328``);
- the streaming :class:`SSIMMetric` (``ssim.py:479-538``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch.metrics.linear import ssim_linear
from lowlight_image_enhancement_tpu_torch.metrics.psnr import host_array
from lowlight_image_enhancement_tpu_torch.ops.image_ops import (
    resize_bilinear,
)

_BT601 = (0.299, 0.587, 0.114)


def _infer_data_range(*imgs: torch.Tensor) -> float:
    """The data range among {1.0, 2.0, 255.0} that the values suggest."""
    lo = min(float(i.min()) for i in imgs)
    hi = max(float(i.max()) for i in imgs)
    if lo < -0.01:
        return 2.0  # [-1, 1]
    if hi > 2.0:
        return 255.0
    return 1.0


def _to_luma(x: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_BT601, dtype=x.dtype, device=x.device)
    return torch.einsum("nchw,c->nhw", x, w)[:, None]


def _center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    top, left = (x.shape[2] - h) // 2, (x.shape[3] - w) // 2
    return x[:, :, top:top + h, left:left + w]


def align_pair(pred: torch.Tensor, target: torch.Tensor, policy: str):
    """``(pred, target)`` brought to one shape: unchanged when they match,
    else both center-cropped or resized to the smaller H and W (``policy``
    ``center_crop`` / ``resize``); ``error`` raises."""
    if pred.shape == target.shape:
        return pred, target
    if policy == "error":
        raise ValueError(f"shape mismatch {tuple(pred.shape)} vs "
                         f"{tuple(target.shape)} with align_policy='error'")
    h = min(pred.shape[2], target.shape[2])
    w = min(pred.shape[3], target.shape[3])
    if policy == "center_crop":
        return _center_crop(pred, h, w), _center_crop(target, h, w)
    if policy == "resize":
        return resize_bilinear(pred, (h, w)), resize_bilinear(target, (h, w))
    raise ValueError(f"unknown align policy {policy!r}")


class SSIMEvaluator:
    """Configurable SSIM over NCHW batches: an explicit or inferred
    ``data_range``, the Gaussian window (k=11, sigma=1.5, k1=.01, k2=.03),
    optional BT.601 luma, and an align policy for mismatched shapes."""

    def __init__(self, data_range: Optional[float] = None,
                 kernel_size: int = 11, sigma: float = 1.5,
                 k1: float = 0.01, k2: float = 0.03, gaussian: bool = True,
                 use_luma: bool = False, align_policy: str = "error",
                 padding: str = "reflect"):
        if kernel_size % 2 != 1:
            raise ValueError("kernel_size must be odd")
        self.data_range = data_range
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.k1 = k1
        self.k2 = k2
        self.gaussian = gaussian
        self.use_luma = use_luma
        self.align_policy = align_policy
        self.padding = padding

    def _effective_kernel(self, h: int, w: int) -> int:
        """The window clipped to the image size, kept odd (>= 3)."""
        k = min(self.kernel_size, h, w)
        if k % 2 == 0:
            k -= 1
        return max(k, 3)

    def per_image(self, pred: torch.Tensor,
                  target: torch.Tensor) -> np.ndarray:
        """Per-image SSIM scores ``[N]``."""
        p = torch.as_tensor(pred).float()
        t = torch.as_tensor(target).float()
        if p.dim() != 4 or t.dim() != 4:
            raise ValueError("expected NCHW [N,C,H,W] batches")
        p, t = align_pair(p, t, self.align_policy)
        if self.use_luma:
            if p.shape[1] != 3:
                raise ValueError("luma mode requires 3-channel input")
            p, t = _to_luma(p), _to_luma(t)
        dr = self.data_range or _infer_data_range(p, t)
        k = self._effective_kernel(p.shape[2], p.shape[3])
        scores = ssim_linear(p, t, data_range=dr, kernel_size=k,
                             sigma=self.sigma, k1=self.k1, k2=self.k2,
                             gaussian=self.gaussian, padding=self.padding,
                             reduction="none")
        return host_array(scores)

    def evaluate(self, pred: torch.Tensor,
                 target: torch.Tensor) -> Dict[str, Any]:
        """Scores, their statistics and the configuration."""
        scores = self.per_image(pred, target)
        dr = self.data_range or _infer_data_range(torch.as_tensor(pred),
                                                  torch.as_tensor(target))
        return {
            "ssim_mean": float(np.mean(scores)),
            "ssim_std": float(np.std(scores)),
            "ssim_p50": float(np.percentile(scores, 50)),
            "ssim_p95": float(np.percentile(scores, 95)),
            "per_image": scores.tolist(),
            "config": {
                "data_range": dr,
                "kernel_size": self.kernel_size,
                "sigma": self.sigma,
                "k1": self.k1,
                "k2": self.k2,
                "gaussian": self.gaussian,
                "use_luma": self.use_luma,
                "align_policy": self.align_policy,
                "padding": self.padding,
            },
        }


def calculate_ssim(pred: torch.Tensor, target: torch.Tensor,
                   data_range: float = 1.0, **kwargs) -> float:
    """Batch-mean SSIM."""
    ev = SSIMEvaluator(data_range=data_range, **kwargs)
    return float(np.mean(ev.per_image(pred, target)))


def calculate_ssim_per_image(pred: torch.Tensor, target: torch.Tensor,
                             data_range: float = 1.0,
                             **kwargs) -> np.ndarray:
    return SSIMEvaluator(data_range=data_range, **kwargs).per_image(
        pred, target)


def evaluate_pairs_ssim(pairs, data_range: Optional[float] = None,
                        **kwargs) -> Dict[str, Any]:
    """SSIM over an iterable of (pred, target) NCHW pairs."""
    ev = SSIMEvaluator(data_range=data_range, **kwargs)
    scores: List[float] = []
    for pred, target in pairs:
        scores.extend(ev.per_image(pred, target).tolist())
    arr = np.asarray(scores)
    return {
        "ssim_mean": float(arr.mean()),
        "ssim_std": float(arr.std()),
        "count": int(arr.size),
        "per_image": scores,
    }


class SSIMMetric:
    """Streaming SSIM accumulator (reference ``ssim.py:479-538``)."""

    def __init__(self, data_range: Optional[float] = None, **kwargs):
        self._ev = SSIMEvaluator(data_range=data_range, **kwargs)
        self.reset()

    def reset(self) -> None:
        self._sum = 0.0
        self._count = 0

    def update(self, pred: torch.Tensor, target: torch.Tensor) -> None:
        scores = self._ev.per_image(pred, target)
        self._sum += float(scores.sum())
        self._count += scores.size

    def compute(self) -> float:
        if self._count == 0:
            raise RuntimeError("SSIMMetric.compute() called before update()")
        return self._sum / self._count
