"""Loss components: perceptual, SSIM, DeltaE00 and the physics terms
(NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/losses/components.py``
(reference ``NewBP_model/losses.py:32-220``):

- :class:`PerceptualLoss`: frozen VGG19 relu5_4 features, MSE (or L1);
  the target branch runs under ``torch.no_grad()`` (the JAX
  ``stop_gradient``), so it builds no graph;
- :class:`SSIMLoss`: DSSIM ``(1 - SSIM) / 2`` on [0,1]-clamped inputs;
- :class:`DeltaE00Loss`: mean CIEDE2000, the reference's training
  variant by default;
- :class:`PhysicsConsistencyLoss` (RAW): ``|K * pad_repl(Bhat) -
  clamp(A * rho)|_1`` -- the training direction scales **A** by rho;
- :func:`align_exposure_srgb` and :class:`PhysicalConsistencyLossSRGB`:
  ``|PSF(Bhat) - clamp(A * rho)|_1`` with the PSF on the prediction only.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from lowlight_image_enhancement_tpu_torch.metrics.linear import ssim_linear
from lowlight_image_enhancement_tpu_torch.models.vgg import (
    load_vgg19_features,
)
from lowlight_image_enhancement_tpu_torch.ops.color import deltaE2000_rgb
from lowlight_image_enhancement_tpu_torch.ops.psf import (
    CrosstalkPSF,
    depthwise_conv,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import LOSS_REGISTRY

Scalar = Union[torch.Tensor, float]


@LOSS_REGISTRY.register()
class PerceptualLoss(nn.Module):
    """Frozen-VGG19 feature loss on sRGB [0,1] inputs (clamped by the
    trunk). ``dtype`` is the trunk's compute type (bf16 under AMP);
    ``pool_impl`` is the trunk's (:class:`...models.vgg.VGG19Features`)."""

    def __init__(self, criterion: str = "mse", taps=("relu5_4",),
                 weights_path: Optional[str] = None,
                 require_pretrained: bool = False, loss_weight: float = 1.0,
                 dtype: Optional[torch.dtype] = None,
                 pool_impl: Optional[str] = None):
        super().__init__()
        if criterion not in {"mse", "l1"}:
            raise ValueError("criterion must be 'mse' or 'l1'")
        self.criterion = criterion
        self.loss_weight = float(loss_weight)
        self.vgg, self.pretrained = load_vgg19_features(
            taps=taps, weights_path=weights_path,
            dtype=dtype if dtype is not None else torch.float32,
            pool_impl=pool_impl)
        if require_pretrained and not self.pretrained:
            raise RuntimeError(
                "PerceptualLoss: pretrained VGG19 weights not found. The "
                "reference trains against ImageNet VGG19 features "
                "(NewBP_model/losses.py:32-69); training with random "
                "features silently changes the objective. Provide weights "
                "(tools/convert_vgg_weights.py -> $LLIE_VGG19_NPZ) or set "
                "`pretrained: false` in hybrid_opt to opt into random "
                "features explicitly.")

    def forward(self, pred: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
        fp = self.vgg(pred)
        with torch.no_grad():
            ft = self.vgg(target)
        total = 0.0
        for name in fp:
            d = fp[name] - ft[name]
            total = total + ((d * d).mean() if self.criterion == "mse"
                             else d.abs().mean())
        return self.loss_weight * total / len(fp)


@LOSS_REGISTRY.register()
class SSIMLoss:
    """DSSIM ``(1 - SSIM) / 2``, inputs clamped to [0, 1], window 11."""

    def __init__(self, window_size: int = 11, max_val: float = 1.0,
                 loss_weight: float = 1.0):
        self.window_size = window_size
        self.max_val = max_val
        self.loss_weight = float(loss_weight)

    def __call__(self, pred: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        s = ssim_linear(pred.clamp(0.0, 1.0), target.clamp(0.0, 1.0),
                        data_range=self.max_val,
                        kernel_size=self.window_size)
        return self.loss_weight * (1.0 - s) / 2.0


@LOSS_REGISTRY.register()
class DeltaE00Loss:
    """Mean CIEDE2000 over sRGB [0,1] images; ``formula`` as in
    :func:`...ops.color.deltaE2000_rgb` (``"reference_loss"`` default)."""

    def __init__(self, clamp_input: bool = True, loss_weight: float = 1.0,
                 formula: str = "reference_loss"):
        self.clamp_input = clamp_input
        self.loss_weight = float(loss_weight)
        self.formula = formula

    def __call__(self, pred: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        if self.clamp_input:
            pred = pred.clamp(0.0, 1.0)
            target = target.clamp(0.0, 1.0)
        return self.loss_weight * deltaE2000_rgb(
            pred, target, formula=self.formula).mean()


def _broadcast_expo(expo: Scalar, like: torch.Tensor) -> torch.Tensor:
    e = torch.as_tensor(expo, dtype=like.dtype, device=like.device)
    if e.dim() == 0 or e.dim() == 4:
        return e
    if e.dim() == 1:
        return e[:, None, None, None]
    raise ValueError(f"unsupported exposure shape {tuple(e.shape)}")


def align_exposure_srgb(a_srgb: torch.Tensor,
                        expo_ratio: Scalar) -> torch.Tensor:
    """``clamp(A_srgb * rho, 0, 1)`` (reference ``losses.py:195-203``)."""
    return (a_srgb * _broadcast_expo(expo_ratio, a_srgb)).clamp(0.0, 1.0)


class PhysicsConsistencyLoss:
    """RAW physics term, training direction:
    ``mean |depthwise(pad_replicate(Bhat_raw), K) - clamp(A_raw * rho)|``
    with the target detached."""

    def __init__(self, kernel: torch.Tensor, clamp_target: bool = True):
        self.kernel = torch.as_tensor(kernel)
        self.clamp_target = clamp_target

    def __call__(self, bhat_raw: torch.Tensor, a_raw: torch.Tensor,
                 expo_ratio: Scalar) -> torch.Tensor:
        projected = depthwise_conv(bhat_raw, self.kernel, padding="replicate")
        aligned = _broadcast_expo(expo_ratio, a_raw) * a_raw
        if self.clamp_target:
            aligned = aligned.clamp(0.0, 1.0)
        return (projected - aligned.detach()).abs().mean()


class PhysicalConsistencyLossSRGB:
    """sRGB physics term ``mean |PSF(Bhat) - align(A; rho)|``: the PSF
    module is applied to the prediction only (Scenario B)."""

    def __init__(self, psf: CrosstalkPSF):
        self.psf = psf

    def __call__(self, bhat_srgb: torch.Tensor, a_srgb: torch.Tensor,
                 expo_ratio: Scalar) -> torch.Tensor:
        aligned = align_exposure_srgb(a_srgb.detach(), expo_ratio)
        return (self.psf(bhat_srgb) - aligned).abs().mean()
