"""Elementwise restoration losses (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/losses/basic.py``
(reference ``NAFNet_base/basicsr/models/losses/losses.py:18-139``): pure
functions ``loss(pred, target, weight=None, reduction=...)`` and the
registered class wrappers with ``loss_weight`` and ``reduction``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from lowlight_image_enhancement_tpu_torch.utils.registry import LOSS_REGISTRY

_REDUCTIONS = {"none", "mean", "sum"}


def _reduce(x: torch.Tensor, weight: Optional[torch.Tensor],
            reduction: str) -> torch.Tensor:
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be one of {_REDUCTIONS}")
    if weight is not None:
        x = x * weight
    if reduction == "none":
        return x
    return x.sum() if reduction == "sum" else x.mean()


def l1_loss(pred, target, weight=None, reduction: str = "mean"):
    return _reduce((pred - target).abs(), weight, reduction)


def mse_loss(pred, target, weight=None, reduction: str = "mean"):
    return _reduce((pred - target) ** 2, weight, reduction)


def charbonnier_loss(pred, target, weight=None, reduction: str = "mean",
                     eps: float = 1e-12):
    return _reduce(torch.sqrt((pred - target) ** 2 + eps), weight, reduction)


_BT601_Y = (65.481 / 255.0, 128.553 / 255.0, 24.966 / 255.0)


def psnr_loss(pred, target, *, to_y: bool = False,
              data_range: float = 1.0) -> torch.Tensor:
    """Negative PSNR (reference ``PSNRLoss``, BT.601 luma with ``to_y``);
    NCHW in [0, data_range]."""
    if to_y:
        w = torch.tensor(_BT601_Y, dtype=pred.dtype,
                         device=pred.device).view(1, 3, 1, 1)
        pred = (pred * w).sum(1, keepdim=True) + 16.0 / 255.0
        target = (target * w).sum(1, keepdim=True) + 16.0 / 255.0
    mse = ((pred - target) ** 2).mean((1, 2, 3))
    psnr = 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))
    return -psnr.mean()


class _WeightedLoss:
    """Class-style wrapper with the reference constructor API."""

    def __init__(self, fn: Callable, loss_weight: float = 1.0,
                 reduction: str = "mean", **kwargs):
        if reduction not in _REDUCTIONS:
            raise ValueError(f"reduction must be one of {_REDUCTIONS}")
        self.fn = fn
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.kwargs = kwargs

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * self.fn(
            pred, target, weight, reduction=self.reduction, **self.kwargs)


@LOSS_REGISTRY.register()
class L1Loss(_WeightedLoss):
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        super().__init__(l1_loss, loss_weight, reduction)


@LOSS_REGISTRY.register()
class MSELoss(_WeightedLoss):
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        super().__init__(mse_loss, loss_weight, reduction)


@LOSS_REGISTRY.register()
class CharbonnierLoss(_WeightedLoss):
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean",
                 eps: float = 1e-12):
        super().__init__(charbonnier_loss, loss_weight, reduction, eps=eps)


@LOSS_REGISTRY.register()
class PSNRLoss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean",
                 toY: bool = False):
        if reduction != "mean":
            raise ValueError("PSNRLoss supports reduction='mean' only")
        self.loss_weight = loss_weight
        self.toY = toY

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * psnr_loss(pred, target, to_y=self.toY)
