"""Aggregate model evaluation loop.

Counterpart of ``lowlight_image_enhancement_tpu/metrics/evaluation.py``
(reference ``metrics/evaluation.py``, whose wiring the JAX module repairs;
SURVEY.md C45): PSNR, SSIM, LPIPS (vgg), DeltaE00 mean/p95, edge-DeltaE00
(Sobel >= q0.90), per-channel PSNR and the physics-consistency MAE, each
weighted by the batch's image count.

``compute_metrics(forward, loader, psf_kernel=...)`` iterates batches of
``{lq, gt, short_raw?, expo_ratio?}``: numpy arrays are NHWC, as the
port's :class:`..data.Loader` yields them; tensors are NCHW. Each array is
moved to ``device`` as an NCHW fp32 tensor, ``forward`` maps ``lq`` there
to the restored NCHW batch, and the metrics run on the device.
Linear -> sRGB goes through the shared EOTF
(:func:`..ops.color.linear_to_srgb`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.metrics.channelwise import rgb_psnr
from lowlight_image_enhancement_tpu_torch.metrics.color_error import (
    deltaE2000_summary,
    edge_deltaE2000,
)
from lowlight_image_enhancement_tpu_torch.metrics.linear import (
    psnr_linear,
    ssim_linear,
)
from lowlight_image_enhancement_tpu_torch.metrics.phys_consistency import (
    phys_cons_raw,
)
from lowlight_image_enhancement_tpu_torch.ops.color import linear_to_srgb


def _on_device(value: Any, dev: torch.device) -> torch.Tensor:
    """A batch entry as an fp32 tensor on ``dev``: numpy images (NHWC)
    become NCHW; tensors are taken as NCHW already."""
    if isinstance(value, torch.Tensor):
        return value.to(dev, torch.float32)
    arr = np.asarray(value, np.float32)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    return t.permute(0, 3, 1, 2).contiguous() if arr.ndim == 4 else t


def compute_metrics(forward: Callable[[torch.Tensor], torch.Tensor],
                    loader: Iterable[Mapping[str, Any]], *,
                    data_range: float = 1.0,
                    psf_kernel: Optional[Any] = None,
                    use_lpips: bool = True, lpips_net: str = "vgg",
                    srgb_convert: bool = False,
                    max_batches: Optional[int] = None,
                    device: Any = "cuda") -> Dict[str, float]:
    """Metric means of ``forward(lq) -> sr`` over ``loader`` on
    ``device``."""
    dev = resolve_device(device)
    lpips_metric = None
    if use_lpips:
        from lowlight_image_enhancement_tpu_torch.metrics.lpips_metric import (
            LPIPSMetric,
        )

        lpips_metric = LPIPSMetric(net=lpips_net, device=dev)

    sums: Dict[str, float] = {}
    weights: Dict[str, float] = {}
    n_images = 0

    def acc(key: str, value: float, weight: float = 1.0):
        sums[key] = sums.get(key, 0.0) + value * weight
        weights[key] = weights.get(key, 0.0) + weight

    for bi, batch in enumerate(loader):
        if max_batches and bi >= max_batches:
            break
        lq = _on_device(batch["lq"], dev)
        gt = _on_device(batch["gt"], dev)
        with torch.no_grad():
            sr = forward(lq).float()
        n = int(lq.shape[0])
        n_images += n

        acc("psnr", float(psnr_linear(sr, gt, data_range=data_range)), n)
        acc("ssim", float(ssim_linear(sr, gt, data_range=data_range)), n)
        acc("rgb_psnr_mean", rgb_psnr(sr, gt, data_range=data_range)["mean"],
            n)

        sr_srgb = sr.clamp(0, 1)
        gt_srgb = gt.clamp(0, 1)
        if srgb_convert:
            sr_srgb, gt_srgb = linear_to_srgb(sr_srgb), linear_to_srgb(gt_srgb)
        de = deltaE2000_summary(sr_srgb, gt_srgb, percentiles=(95.0,))
        acc("deltaE_mean", de["mean"], n)
        acc("deltaE_p95", de["p95"], n)
        ede = edge_deltaE2000(sr_srgb, gt_srgb, edge_quantile=0.90)
        acc("edge_deltaE_mean", ede["mean"], n)

        if lpips_metric is not None:
            acc("lpips", lpips_metric.distance(sr_srgb, gt_srgb), n)

        if psf_kernel is not None and "short_raw" in batch:
            acc("phys_mae", float(phys_cons_raw(
                sr, _on_device(batch["short_raw"], dev), psf_kernel,
                batch.get("expo_ratio", 1.0))), n)

    if n_images == 0:
        return {}
    return {k: sums[k] / weights[k] for k in sums}
