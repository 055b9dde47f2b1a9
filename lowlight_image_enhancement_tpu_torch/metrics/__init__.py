"""Metrics of the port (NCHW tensors) and the config bridge names.

Counterpart of ``lowlight_image_enhancement_tpu/metrics/__init__.py``:
the functional metrics ported so far (linear-domain PSNR/SSIM,
CIEDE2000) and the names a validation config's ``val.metrics.<name>.type``
resolves through ``METRIC_REGISTRY`` (reference
``basicsr/metrics/lowlight_metrics.py:211-272``):

- ``linear_psnr(sr, gt, data_range=...)``, ``linear_ssim(sr, gt,
  data_range=...)``;
- ``deltae2000_mean``, ``deltae2000_p95``;
- ``edge_deltae2000_mean(sr, gt, edge_quantile=...)``.

Each takes NCHW ``[N, C, H, W]`` tensors and returns a float.
``lpips_distance`` and the image-domain ``psnr``/``ssim`` are registered
too but raise: LPIPS and the uint8 MATLAB-convention metrics wait for the
rest of ``metrics/`` (ROADMAP.md, queue 1 item 4).
"""

from __future__ import annotations

from lowlight_image_enhancement_tpu_torch.metrics.color_error import (  # noqa: F401
    deltaE2000_map,
    deltaE2000_summary,
    edge_deltaE2000,
)
from lowlight_image_enhancement_tpu_torch.metrics.linear import (  # noqa: F401
    psnr_linear,
    ssim_linear,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import (
    METRIC_REGISTRY,
)


@METRIC_REGISTRY.register()
def linear_psnr(sr, gt, data_range: float = 1.0, **kwargs) -> float:
    """Linear-domain PSNR (dB), the mean over the batch's images."""
    return float(psnr_linear(sr, gt, data_range=data_range,
                             reduction="none").mean())


@METRIC_REGISTRY.register()
def linear_ssim(sr, gt, data_range: float = 1.0, **kwargs) -> float:
    """Linear-domain SSIM over the batch."""
    return float(ssim_linear(sr, gt, data_range=data_range))


@METRIC_REGISTRY.register()
def deltae2000_mean(sr, gt, **kwargs) -> float:
    return deltaE2000_summary(sr, gt)["mean"]


@METRIC_REGISTRY.register()
def deltae2000_p95(sr, gt, **kwargs) -> float:
    return deltaE2000_summary(sr, gt, percentiles=(95.0,))["p95"]


@METRIC_REGISTRY.register()
def edge_deltae2000_mean(sr, gt, edge_quantile: float = 0.85,
                         **kwargs) -> float:
    return edge_deltaE2000(sr, gt, edge_quantile=edge_quantile)["mean"]


def _not_ported(name: str):
    def metric(sr, gt, **kwargs) -> float:
        raise NotImplementedError(
            f"metric {name!r} is not ported yet: LPIPS and the image-domain "
            "PSNR/SSIM wait for the rest of metrics/ (ROADMAP.md, queue 1 "
            "item 4)")

    metric.__name__ = name
    return metric


for _name in ("lpips_distance", "psnr", "ssim"):
    METRIC_REGISTRY.register(_not_ported(_name), name=_name)
