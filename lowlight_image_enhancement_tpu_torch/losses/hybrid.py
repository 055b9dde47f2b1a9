"""Hybrid training losses (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/losses/hybrid.py``
(reference ``NewBP_model/losses.py:72-89, 223-372``):

- :class:`HybridLoss`: ``lambda_l1 * L1 + lambda_perc * Perceptual``,
  returning ``(total, l1, perc)``;
- :class:`HybridLossPlus`: the training loss -- L1 on raw, perceptual,
  LPIPS (vgg, off by default), DeltaE00, SSIM and one physics term (RAW or
  sRGB), with optional Kendall-Gal uncertainty weighting (``L * exp(-2 s)
  + s``; the trainable ``s`` live in :attr:`HybridLossPlus.log_sigma`, an
  ``nn.ParameterDict``) and detached per-term logs;
- :func:`assert_finite_logs`: the host-side NaN/Inf guard.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from lowlight_image_enhancement_tpu_torch.losses.components import (
    DeltaE00Loss,
    PerceptualLoss,
    PhysicalConsistencyLossSRGB,
    PhysicsConsistencyLoss,
    Scalar,
    SSIMLoss,
)
from lowlight_image_enhancement_tpu_torch.models.lpips import (
    LPIPSNet,
    load_lpips,
)
from lowlight_image_enhancement_tpu_torch.ops.psf import CrosstalkPSF
from lowlight_image_enhancement_tpu_torch.utils.registry import LOSS_REGISTRY


class HybridLoss(nn.Module):
    """``lambda_l1 * L1 + lambda_perc * Perceptual(VGG19)`` (reference
    ``losses.py:72-89``)."""

    def __init__(self, lambda_l1: float = 1.0, lambda_perc: float = 0.01,
                 perceptual: Optional[PerceptualLoss] = None):
        super().__init__()
        self.lambda_l1 = lambda_l1
        self.lambda_perc = lambda_perc
        self.perceptual = perceptual or PerceptualLoss()

    def forward(self, pred: torch.Tensor, target: torch.Tensor):
        l1 = (pred - target).abs().mean()
        perc = self.perceptual(pred.clamp(0.0, 1.0), target.clamp(0.0, 1.0))
        return self.lambda_l1 * l1 + self.lambda_perc * perc, l1, perc


_UNCERTAINTY_TERMS = ("l1_raw", "perc", "lpips", "deltaE", "ssim", "phys")


@LOSS_REGISTRY.register()
class HybridLossPlus(nn.Module):
    """The NewBP training loss (reference ``losses.py:223-372``).

    Weights and flags default as in the reference (``w_l1_raw=1.0,
    w_perc=0.02, w_lpips=0.0, w_deltaE=0.02, w_ssim=0.05, w_phys=0.10``);
    with ``use_phys`` exactly one of ``physics_kernel`` (RAW) or
    ``physics_psf_module`` (sRGB) must be given; ``perc_pool_impl`` is the
    perceptual trunk's ``pool_impl``. ``use_lpips`` adds ``mean(LPIPS-vgg(
    clip(Bhat, 0, 1) * 2 - 1, clip(B, 0, 1) * 2 - 1))`` in fp32 through
    ``lpips`` (an :class:`LPIPSNet`; by default ``load_lpips(net="vgg")``,
    which must find converted weights when ``require_pretrained``). Call
    with NCHW keywords::

        total, logs = loss(Bhat_raw=..., B_raw=..., A_raw=...,
                           expo_ratio=..., Bhat_srgb01=..., B_srgb01=...,
                           A_srgb01=None, log_sigma=None)

    ``logs`` holds detached per-term values (before weighting) and the
    weighted total ``l_total``."""

    def __init__(self, w_l1_raw: float = 1.0, w_perc: float = 0.02,
                 w_lpips: float = 0.0, w_deltaE: float = 0.02,
                 w_ssim: float = 0.05, w_phys: float = 0.10,
                 use_perc: bool = True, use_lpips: bool = False,
                 use_deltaE: bool = True, use_ssim: bool = True,
                 use_phys: bool = True, use_uncertainty: bool = False,
                 physics_kernel: Optional[torch.Tensor] = None,
                 physics_psf_module: Optional[CrosstalkPSF] = None,
                 perceptual: Optional[PerceptualLoss] = None,
                 lpips: Optional[LPIPSNet] = None,
                 require_pretrained: bool = False,
                 perc_dtype: Optional[torch.dtype] = None,
                 perc_pool_impl: Optional[str] = None,
                 **_ignored: Any):
        super().__init__()
        if use_phys and ((physics_kernel is None)
                         == (physics_psf_module is None)):
            raise ValueError("use_phys requires exactly one of "
                             "physics_kernel (RAW) or physics_psf_module "
                             "(sRGB)")
        self.w = dict(l1_raw=w_l1_raw, perc=w_perc, lpips=w_lpips,
                      deltaE=w_deltaE, ssim=w_ssim, phys=w_phys)
        self.use = dict(perc=use_perc, lpips=use_lpips, deltaE=use_deltaE,
                        ssim=use_ssim, phys=use_phys)
        self.use_uncertainty = use_uncertainty
        self.perceptual = None
        if use_perc:
            self.perceptual = perceptual or PerceptualLoss(
                require_pretrained=require_pretrained, dtype=perc_dtype,
                pool_impl=perc_pool_impl)
        self.lpips = None
        if use_lpips:
            if lpips is None:
                lpips, lpips_pretrained = load_lpips(net="vgg")
                if require_pretrained and not lpips_pretrained:
                    raise RuntimeError(
                        "HybridLossPlus(use_lpips=True): pretrained LPIPS "
                        "weights not found (the reference uses LPIPS v0.1 "
                        "vgg, NewBP_model/losses.py:246-252). Provide "
                        "weights (tools/convert_lpips_weights.py -> "
                        "$LLIE_LPIPS_NPZ) or set `pretrained: false` to opt "
                        "into random features.")
            self.lpips = lpips
        self.deltaE = DeltaE00Loss() if use_deltaE else None
        self.ssim = SSIMLoss() if use_ssim else None
        self.phys_raw = (PhysicsConsistencyLoss(physics_kernel)
                         if use_phys and physics_kernel is not None else None)
        self.psf = (physics_psf_module
                    if use_phys and physics_psf_module is not None else None)
        self.phys_srgb = (PhysicalConsistencyLossSRGB(self.psf)
                          if self.psf is not None else None)
        # zero-initialised log sigma per active term (trainable)
        self.log_sigma = nn.ParameterDict()
        if use_uncertainty:
            for term in _UNCERTAINTY_TERMS:
                if term == "l1_raw" or self.use.get(term):
                    self.log_sigma[term] = nn.Parameter(torch.zeros(()))

    def _weight_term(self, name: str, value: torch.Tensor,
                     log_sigma: Optional[Mapping[str, torch.Tensor]]):
        if self.use_uncertainty and log_sigma is not None \
                and name in log_sigma:
            s = log_sigma[name]
            return value * torch.exp(-2.0 * s) + s
        return self.w[name] * value

    def forward(self, *, Bhat_raw: torch.Tensor, B_raw: torch.Tensor,
                A_raw: torch.Tensor, expo_ratio: Scalar,
                Bhat_srgb01: torch.Tensor, B_srgb01: torch.Tensor,
                A_srgb01: Optional[torch.Tensor] = None,
                log_sigma: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logs: Dict[str, torch.Tensor] = {}

        def add(name, key, value, total):
            logs[key] = value.detach()
            return total + self._weight_term(name, value, log_sigma)

        total = add("l1_raw", "l_l1_raw", (Bhat_raw - B_raw).abs().mean(),
                    torch.zeros((), device=Bhat_raw.device))
        if self.perceptual is not None:
            total = add("perc", "l_perc",
                        self.perceptual(Bhat_srgb01, B_srgb01), total)
        if self.lpips is not None:
            lp = self.lpips(Bhat_srgb01.float().clamp(0, 1) * 2.0 - 1.0,
                            B_srgb01.float().clamp(0, 1) * 2.0 - 1.0).mean()
            total = add("lpips", "l_lpips", lp, total)
        if self.deltaE is not None:
            total = add("deltaE", "l_deltaE",
                        self.deltaE(Bhat_srgb01, B_srgb01), total)
        if self.ssim is not None:
            total = add("ssim", "l_ssim", self.ssim(Bhat_srgb01, B_srgb01),
                        total)
        if self.phys_raw is not None:
            total = add("phys", "l_phys",
                        self.phys_raw(Bhat_raw, A_raw, expo_ratio), total)
        elif self.phys_srgb is not None:
            a_srgb = A_srgb01 if A_srgb01 is not None else A_raw.clamp(0, 1)
            total = add("phys", "l_phys",
                        self.phys_srgb(Bhat_srgb01, a_srgb, expo_ratio),
                        total)
        logs["l_total"] = total.detach()
        return total, logs


def assert_finite_logs(logs: Mapping[str, Any]) -> None:
    """Raise ``FloatingPointError`` when a log value is NaN or Inf (the
    reference's ``_ensure_finite``, ``losses.py:298-306``)."""
    vals = {k: float(v) for k, v in logs.items()}
    bad = {k: v for k, v in vals.items() if not math.isfinite(v)}
    if bad:
        raise FloatingPointError(
            f"non-finite loss terms detected: {bad} (all logs: {vals})")
