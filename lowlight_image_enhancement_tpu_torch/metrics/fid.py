"""Frechet Inception Distance (stock BasicSR parity; NCHW images).

Counterpart of ``lowlight_image_enhancement_tpu/metrics/fid.py``
(reference ``basicsr/metrics/fid.py``): the Frechet distance between
Gaussian fits of two feature populations,

    FID = |mu1 - mu2|^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2}),

with a pluggable feature extractor ``images -> [N, D]``. The statistics
and the distance are host numpy/scipy, copied from the JAX module; the
extractors run on ``device`` (``"cuda"`` by default):

- :func:`inception_feature_extractor`: InceptionV3 pool3 (the standard
  protocol); raises without converted weights unless ``allow_random``;
- :func:`vgg_feature_extractor`: the bundled VGG19 relu5_4 trunk, mean
  pooled to ``[N, 512]``; ``pool_impl`` is the trunk's
  (:class:`...models.vgg.VGG19Features`), so ``"kernel_fused"`` runs its
  four stage-final pools through kernel K7.

Each extractor carries ``.metadata`` and ``.module`` (the model it runs).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from scipy import linalg

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.metrics.psnr import host_array


def compute_feature_stats(features: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """``(mean [D], covariance [D, D])`` of a feature population
    ``[N, D]``."""
    features = host_array(features, np.float64)
    if features.ndim != 2:
        raise ValueError(f"expected [N, D] features, got {features.shape}")
    mu = features.mean(axis=0)
    cov = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(cov)


def calculate_fid_from_stats(mu1: np.ndarray, cov1: np.ndarray,
                             mu2: np.ndarray, cov2: np.ndarray,
                             eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (the reference's numerics:
    ``sqrtm`` retried with an eps jitter, imaginary part stripped)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    cov1, cov2 = np.atleast_2d(cov1), np.atleast_2d(cov2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("sqrtm produced significant imaginary part")
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(covmean))


def _on(dev: torch.device, images) -> torch.Tensor:
    return torch.as_tensor(images).to(dev, torch.float32)


def vgg_feature_extractor(pool_impl: Optional[str] = None,
                          device: Any = "cuda"
                          ) -> Callable[[torch.Tensor], np.ndarray]:
    """VGG19 relu5_4 features of NCHW [0, 1] images, mean pooled to
    ``[N, 512]``: converted ImageNet weights where ``models/vgg.py`` finds
    them, else its deterministic random trunk (FID then compares only
    with itself, never with published Inception-FID numbers)."""
    from lowlight_image_enhancement_tpu_torch.models.vgg import (
        load_vgg19_features,
    )

    dev = resolve_device(device)
    module, pretrained = load_vgg19_features(taps=("relu5_4",),
                                             pool_impl=pool_impl)
    module = module.to(dev).eval()

    @torch.no_grad()
    def extract(images) -> np.ndarray:
        return host_array(module(_on(dev, images))["relu5_4"].mean((2, 3)))

    extract.module = module
    extract.metadata = {
        "extractor": "vgg19_relu5_4_gap",
        "pretrained": bool(pretrained),
        "pool_impl": pool_impl,
        "note": ("not InceptionV3 pool3: values are NOT comparable to "
                 "published Inception-FID numbers"),
    }
    return extract


def inception_feature_extractor(allow_random: bool = False,
                                device: Any = "cuda"
                                ) -> Callable[[torch.Tensor], np.ndarray]:
    """InceptionV3 pool3 features (2048-d), pytorch-fid's FID variant as
    the reference configures it (``basicsr/metrics/fid.py:14-25``:
    ``resize_input=True``, ``normalize_input=False``); takes NCHW [0, 1]
    images and maps them to [-1, 1]. Needs converted weights
    (``tools/convert_inception_weights.py`` -> ``$LLIE_INCEPTION_NPZ``);
    raises without them unless ``allow_random``."""
    from lowlight_image_enhancement_tpu_torch.models.inception import (
        load_inception_v3,
    )

    dev = resolve_device(device)
    module, pretrained = load_inception_v3()
    if not pretrained and not allow_random:
        raise RuntimeError(
            "FID: pretrained InceptionV3 weights not found. Standard-"
            "protocol FID is defined over InceptionV3 pool3 features "
            "(reference: basicsr/metrics/fid.py). Convert a checkpoint "
            "with tools/convert_inception_weights.py and set "
            "$LLIE_INCEPTION_NPZ, pass allow_random=True for a "
            "self-consistent-only value, or use vgg_feature_extractor() "
            "explicitly.")
    module = module.to(dev)

    @torch.no_grad()
    def extract(images) -> np.ndarray:
        return host_array(module(_on(dev, images) * 2.0 - 1.0))

    extract.module = module
    extract.metadata = {
        "extractor": "inception_v3_pool3_fid_variant",
        "pretrained": bool(pretrained),
        "input_contract": "[0,1] NCHW -> mapped to [-1,1], resized 299",
    }
    return extract


def calculate_fid(images1, images2,
                  feature_extractor: Optional[Callable] = None,
                  batch_size: int = 32, device: Any = "cuda") -> float:
    """FID between two sets of NCHW [0, 1] images, in batches of
    ``batch_size``; the extractor defaults to
    :func:`inception_feature_extractor` on ``device`` (which raises
    without weights)."""
    if feature_extractor is None:
        feature_extractor = inception_feature_extractor(device=device)

    def extract(images):
        return np.concatenate([
            host_array(feature_extractor(images[i:i + batch_size]))
            for i in range(0, len(images), batch_size)], axis=0)

    mu1, cov1 = compute_feature_stats(extract(images1))
    mu2, cov2 = compute_feature_stats(extract(images2))
    return calculate_fid_from_stats(mu1, cov1, mu2, cov2)
