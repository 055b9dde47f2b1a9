"""Metrics of the port (NCHW tensors) and the config bridge names.

Counterpart of ``lowlight_image_enhancement_tpu/metrics/__init__.py``:
the functional library (linear-domain PSNR/SSIM, the SSIM evaluator,
channelwise PSNR/SSIM, CIEDE2000, physics consistency, the uint8
MATLAB-convention PSNR/SSIM, LPIPS, FID, NIQE, FLOPs, latency, parameter
counts, the aggregate ``compute_metrics`` loop) and the names a
validation config's ``val.metrics.<name>.type`` resolves through
``METRIC_REGISTRY`` (reference ``basicsr/metrics/lowlight_metrics.py:
211-272``):

- ``linear_psnr(sr, gt, data_range=...)``, ``linear_ssim(sr, gt,
  data_range=...)``;
- ``lpips_distance(sr, gt, net=...)`` on ``sr``'s device;
- ``deltae2000_mean``, ``deltae2000_p95``;
- ``edge_deltae2000_mean(sr, gt, edge_quantile=...)``;
- ``psnr`` and ``ssim``: the image-domain (uint8, MATLAB convention)
  metrics of the ``use_image: true`` path, per image on the host.

Each takes NCHW ``[N, C, H, W]`` tensors and returns a float.
"""

from __future__ import annotations

import numpy as np

from lowlight_image_enhancement_tpu_torch.metrics.channelwise import (  # noqa: F401
    cpsnr_rgb,
    rgb_psnr,
    rgb_ssim,
)
from lowlight_image_enhancement_tpu_torch.metrics.color_error import (  # noqa: F401
    deltaE2000_map,
    deltaE2000_summary,
    edge_deltaE2000,
)
from lowlight_image_enhancement_tpu_torch.metrics.evaluation import (  # noqa: F401
    compute_metrics,
)
from lowlight_image_enhancement_tpu_torch.metrics.fid import (  # noqa: F401
    calculate_fid,
    calculate_fid_from_stats,
    compute_feature_stats,
    inception_feature_extractor,
    vgg_feature_extractor,
)
from lowlight_image_enhancement_tpu_torch.metrics.flops_utils import (  # noqa: F401
    FLOPsCounter,
    FLOPsResult,
    count_flops,
)
from lowlight_image_enhancement_tpu_torch.metrics.inference_time import (  # noqa: F401
    measure_inference_time,
)
from lowlight_image_enhancement_tpu_torch.metrics.linear import (  # noqa: F401
    psnr_linear,
    ssim_linear,
)
from lowlight_image_enhancement_tpu_torch.metrics.lpips_metric import (  # noqa: F401
    LPIPSEvaluator,
    LPIPSMetric,
    evaluate_pairs,
)
from lowlight_image_enhancement_tpu_torch.metrics.niqe import (  # noqa: F401
    calculate_niqe,
    niqe_model_info,
)
from lowlight_image_enhancement_tpu_torch.metrics.parameter_utils import (  # noqa: F401
    count_parameters,
)
from lowlight_image_enhancement_tpu_torch.metrics.perceptual import (  # noqa: F401
    lpips_srgb,
)
from lowlight_image_enhancement_tpu_torch.metrics.phys_consistency import (  # noqa: F401
    phys_cons_raw,
    phys_cons_srgb,
)
from lowlight_image_enhancement_tpu_torch.metrics.psnr import (  # noqa: F401
    calculate_psnr,
    host_array,
)
from lowlight_image_enhancement_tpu_torch.metrics.psnr_ssim_img import (  # noqa: F401
    calculate_psnr_img,
    calculate_ssim_img,
    rgb2ycbcr,
)
from lowlight_image_enhancement_tpu_torch.metrics.ssim import (  # noqa: F401
    SSIMEvaluator,
    SSIMMetric,
    calculate_ssim,
    calculate_ssim_per_image,
    evaluate_pairs_ssim,
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
def lpips_distance(sr, gt, net: str = "alex", **kwargs) -> float:
    """LPIPS distance (lower is better) on ``sr``'s device; random
    features unless converted weights are found (``models/lpips.py``)."""
    return LPIPSMetric(net=net, device=sr.device).distance(sr, gt)


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


def _per_image(metric, sr, gt, **kw) -> float:
    """The mean of ``metric`` over the batch's HWC images on the host."""
    sr = host_array(sr).transpose(0, 2, 3, 1)
    gt = host_array(gt).transpose(0, 2, 3, 1)
    return float(np.mean([metric(s, g, **kw) for s, g in zip(sr, gt)]))


@METRIC_REGISTRY.register(name="psnr")
def image_psnr(sr, gt, crop_border: int = 0, test_y_channel: bool = False,
               **kwargs) -> float:
    """Image-domain PSNR (uint8 MATLAB convention), the batch mean."""
    return _per_image(calculate_psnr_img, sr, gt, crop_border=crop_border,
                      test_y_channel=test_y_channel)


@METRIC_REGISTRY.register(name="ssim")
def image_ssim(sr, gt, crop_border: int = 0, test_y_channel: bool = False,
               **kwargs) -> float:
    """Image-domain SSIM (uint8 MATLAB convention), the batch mean."""
    return _per_image(calculate_ssim_img, sr, gt, crop_border=crop_border,
                      test_y_channel=test_y_channel)
