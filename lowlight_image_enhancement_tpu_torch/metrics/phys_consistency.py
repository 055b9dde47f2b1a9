"""Evaluation-side physics consistency (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/metrics/phys_consistency.py``
(reference ``metrics/phys_consistency.py``): how well a restored image
``Bhat``, pushed back through the crosstalk PSF and scaled by the exposure
ratio, matches the short observation ``A``:

    residual = rho * (K * Bhat) - A

The *metric* applies ``rho`` to ``K * Bhat`` (``phys_consistency.py:
229-236``), whereas the training losses scale ``A`` by ``rho``: both
directions exist in the reference and both are kept.

- :func:`_prepare_psf`: odd kernels, ``[C_k, kh, kw]`` depthwise (``C_k``
  1 or C, made a diagonal full kernel), ``[kh, kw]``, or a full ``[C_out,
  C_in, kh, kw]`` coupling kernel; each output channel normalised to unit
  energy (a warning and no normalisation where it sums to ~0); optional
  non-negativity clamp;
- :func:`_apply_psf`: the full (cross-channel) conv after zero, replicate
  or reflect padding, in fp32 with TF32 off (JAX runs it at
  ``Precision.HIGHEST``);
- :func:`_expand_exposure`: scalar / ``[N]`` / ``[N,1,1,1]`` / full-map
  exposure;
- :func:`_crop_valid`: the conv margin removed before the error norm;
- L1 or Charbonnier penalty, per-sample means, reduction, optional
  residual map. Gradients are stopped, as in JAX: these are metrics.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Union

import torch
import torch.nn.functional as F

ArrayLike = Union[torch.Tensor, float]

_PAD_MODES = {"zero": "constant", "replicate": "replicate",
              "reflect": "reflect"}


def _prepare_psf(kernel: ArrayLike, channels: int, *,
                 normalize: bool = True, clamp_nonneg: bool = False,
                 device: Any = None) -> torch.Tensor:
    """A PSF kernel validated and normalised to ``[C_out, C_in, kh, kw]``
    fp32 on ``device``."""
    k = torch.as_tensor(kernel, dtype=torch.float32, device=device)
    if k.dim() == 2:
        k = k[None]
    eye = torch.eye(channels, dtype=k.dtype, device=k.device)[:, :, None,
                                                              None]
    if k.dim() == 3:
        ck, kh, kw = k.shape
        if ck == 1:
            k = k.expand(channels, kh, kw)
        elif ck != channels:
            raise ValueError(f"depthwise kernel channels {ck} incompatible "
                             f"with input channels {channels}")
        k = eye * k[:, None, :, :]  # the diagonal full kernel
    elif k.dim() == 4:
        if k.shape[0] != channels or k.shape[1] not in (1, channels):
            raise ValueError(f"full kernel {tuple(k.shape)} incompatible "
                             f"with {channels} channels")
        if k.shape[1] == 1:
            k = eye * k[:, 0][:, None, :, :]
    else:
        raise ValueError(f"kernel ndim must be 2..4, got {k.dim()}")
    kh, kw = k.shape[-2:]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"kernel spatial dims must be odd, got {(kh, kw)}")
    if clamp_nonneg:
        k = k.clamp(min=0.0)
    if normalize:
        sums = k.reshape(k.shape[0], -1).sum(1)
        small = sums.abs() < 1e-8
        if bool(small.any()):
            warnings.warn(
                "PSF kernel has ~zero energy in at least one output "
                "channel; normalization skipped for those channels.",
                stacklevel=3)
        k = k / torch.where(small, torch.ones_like(sums), sums)[:, None,
                                                                None, None]
    return k


def _apply_psf(x: torch.Tensor, kernel_full: torch.Tensor,
               padding: str) -> torch.Tensor:
    """Full (cross-channel) conv of NCHW ``x`` with ``[C_out, C_in, kh,
    kw]`` after SAME ``padding``, fp32 with TF32 off."""
    if padding not in _PAD_MODES:
        raise ValueError(f"padding must be one of {sorted(_PAD_MODES)}")
    kh, kw = kernel_full.shape[-2:]
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (pw, pw, ph, ph), mode=_PAD_MODES[padding])
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv2d(xp, kernel_full.to(x.dtype))


def _expand_exposure(expo: ArrayLike, like: torch.Tensor) -> torch.Tensor:
    """Scalar / ``[N]`` / ``[N,1,1,1]`` / full-map exposure broadcast to
    ``like``'s NCHW shape."""
    e = torch.as_tensor(expo, dtype=like.dtype, device=like.device)
    n = like.shape[0]
    if e.dim() == 0:
        return e.expand(like.shape)
    if e.dim() == 1:
        if e.shape[0] != n:
            raise ValueError(f"exposure [N] mismatch: {e.shape[0]} vs {n}")
        return e[:, None, None, None].expand(like.shape)
    if e.dim() == 4:
        return e.expand(like.shape)
    raise ValueError(f"unsupported exposure shape {tuple(e.shape)}")


def _crop_valid(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """``x`` without the conv margin (the reference's valid crop)."""
    ph, pw = kh // 2, kw // 2
    if ph == 0 and pw == 0:
        return x
    return x[:, :, ph:x.shape[2] - ph, pw:x.shape[3] - pw]


@torch.no_grad()
def _phys_cons_core(bhat: torch.Tensor, a_obs: torch.Tensor,
                    kernel: ArrayLike, expo_ratio: ArrayLike, *,
                    padding: str, penalty: str, charbonnier_eps: float,
                    normalize_kernel: bool, clamp_nonneg: bool,
                    reduction: str, return_map: bool
                    ) -> Union[torch.Tensor, Dict[str, Any]]:
    if bhat.shape != a_obs.shape:
        raise ValueError(f"Bhat {tuple(bhat.shape)} and A "
                         f"{tuple(a_obs.shape)} must match (NCHW)")
    if bhat.dim() != 4:
        raise ValueError(f"expected NCHW [N,C,H,W], got ndim {bhat.dim()}")
    if penalty not in {"l1", "charbonnier"}:
        raise ValueError("penalty must be 'l1' or 'charbonnier'")
    if reduction not in {"mean", "sum", "none"}:
        raise ValueError("reduction must be mean|sum|none")

    bhat = bhat.detach().float()
    a_obs = torch.as_tensor(a_obs, device=bhat.device).detach().float()
    k = _prepare_psf(kernel, bhat.shape[1], normalize=normalize_kernel,
                     clamp_nonneg=clamp_nonneg, device=bhat.device)
    kh, kw = k.shape[-2:]

    projected = _apply_psf(bhat, k, padding)
    rho = _expand_exposure(expo_ratio, projected)
    residual = rho * projected - a_obs  # model-faithful: rho*(K*Bhat) vs A

    residual_valid = _crop_valid(residual, kh, kw)
    if penalty == "l1":
        err_map = residual_valid.abs()
    else:
        err_map = torch.sqrt(residual_valid ** 2 + charbonnier_eps ** 2)

    per_sample = err_map.mean((1, 2, 3))
    if reduction == "none":
        value = per_sample
    elif reduction == "sum":
        value = per_sample.sum()
    else:
        value = per_sample.mean()

    if return_map:
        return {
            "value": value,
            "per_sample": per_sample,
            "residual_map": residual,
            "meta": {
                "padding": padding,
                "penalty": penalty,
                "valid_crop": (kh // 2, kw // 2),
                "direction": "rho*(K*Bhat) - A",
            },
        }
    return value


def phys_cons_raw(bhat_raw: torch.Tensor, a_raw: torch.Tensor,
                  kernel: ArrayLike, expo_ratio: ArrayLike, *,
                  padding: str = "reflect", penalty: str = "l1",
                  charbonnier_eps: float = 1e-3,
                  normalize_kernel: bool = True, clamp_nonneg: bool = False,
                  reduction: str = "mean", return_map: bool = False):
    """RAW-domain physics consistency, the primary protocol (reference
    ``phys_consistency.py:257-318``)."""
    return _phys_cons_core(
        bhat_raw, a_raw, kernel, expo_ratio, padding=padding,
        penalty=penalty, charbonnier_eps=charbonnier_eps,
        normalize_kernel=normalize_kernel, clamp_nonneg=clamp_nonneg,
        reduction=reduction, return_map=return_map)


def phys_cons_srgb(bhat_srgb: torch.Tensor, a_srgb: torch.Tensor,
                   kernel: ArrayLike, expo_ratio: ArrayLike, *,
                   padding: str = "reflect", penalty: str = "l1",
                   charbonnier_eps: float = 1e-3,
                   normalize_kernel: bool = True, clamp_nonneg: bool = False,
                   reduction: str = "mean", return_map: bool = False):
    """sRGB-domain physics consistency, the auxiliary protocol (reference
    ``phys_consistency.py:321-368``); inputs in [0,1] sRGB."""
    return _phys_cons_core(
        bhat_srgb, a_srgb, kernel, expo_ratio, padding=padding,
        penalty=penalty, charbonnier_eps=charbonnier_eps,
        normalize_kernel=normalize_kernel, clamp_nonneg=clamp_nonneg,
        reduction=reduction, return_map=return_map)
