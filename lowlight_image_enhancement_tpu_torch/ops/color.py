"""Colour science on NCHW tensors: sRGB EOTF/OETF, RGB -> XYZ -> Lab,
CIEDE2000 (Sharma 2005 and the reference's training-loss variant).

Counterpart of ``lowlight_image_enhancement_tpu/ops/color.py``. The colour
axis is dim 1, so the same functions take ``[N, 3, H, W]`` images and
``[K, 3]`` lists of triplets (the CIEDE2000 gold pairs). Differentiable;
the ``atan2`` inputs are guarded so gray pixels get a zero, not a NaN,
gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# D65 reference white (2 degree observer), CIE XYZ scaled to Y=1.
_D65_WHITE = (0.95047, 1.0, 1.08883)

# sRGB -> XYZ (D65) matrix, IEC 61966-2-1.
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)

_TWO_PI = 2.0 * math.pi


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB electro-optical transfer: gamma-encoded [0,1] -> linear."""
    return torch.where(x > 0.04045,
                       ((x + 0.055) / 1.055).clamp(min=1e-12) ** 2.4,
                       x / 12.92)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """Linear [0,1] -> gamma-encoded sRGB [0,1] (the OETF)."""
    return torch.where(x > 0.0031308,
                       1.055 * x.clamp(min=1e-12) ** (1.0 / 2.4) - 0.055,
                       12.92 * x)


def _channels(x: torch.Tensor, m) -> torch.Tensor:
    """``y[:, d] = sum_c m[d][c] x[:, c]`` on the colour axis (dim 1)."""
    mt = torch.tensor(m, dtype=x.dtype, device=x.device)
    y = torch.tensordot(x.movedim(1, -1), mt, dims=([-1], [1]))
    return y.movedim(-1, 1)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    """Gamma-encoded sRGB [0,1] -> CIE XYZ (D65), colour axis dim 1."""
    return _channels(srgb_to_linear(rgb), _RGB2XYZ)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    delta = 6.0 / 29.0
    return torch.where(t > delta ** 3,
                       torch.pow(t.clamp(min=1e-12), 1.0 / 3.0),
                       t / (3.0 * delta ** 2) + 4.0 / 29.0)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """Gamma-encoded sRGB [0,1] -> CIE Lab (D65/2deg, Kornia's
    convention), colour axis dim 1."""
    xyz = rgb_to_xyz(rgb)
    shape = [1] * xyz.dim()
    shape[1] = 3
    white = torch.tensor(_D65_WHITE, dtype=xyz.dtype,
                         device=xyz.device).view(shape)
    f = _lab_f(xyz / white)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], 1)


def _safe_sqrt(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt(x.clamp(min=eps))


def _hue(b: torch.Tensor, ap: torch.Tensor, zero: torch.Tensor):
    """``atan2(b, a') mod 2 pi`` with guarded inputs where ``zero``."""
    h = torch.atan2(torch.where(zero, torch.zeros_like(b), b),
                    torch.where(zero, torch.ones_like(ap), ap))
    return torch.remainder(h, _TWO_PI)


def ciede2000_lab(lab1: torch.Tensor, lab2: torch.Tensor,
                  eps: float = 1e-12) -> torch.Tensor:
    """Sharma-2005 CIEDE2000 (kL = kC = kH = 1) between Lab triplets on
    dim 1, eps-smoothed square roots (the reference metric,
    ``metrics/color_error.py:104-210``)."""
    L1, a1, b1 = lab1[:, 0], lab1[:, 1], lab1[:, 2]
    L2, a2, b2 = lab2[:, 0], lab2[:, 1], lab2[:, 2]
    C1 = _safe_sqrt(a1 * a1 + b1 * b1, eps)
    C2 = _safe_sqrt(a2 * a2 + b2 * b2, eps)
    C_bar7 = (0.5 * (C1 + C2)) ** 7
    G = 0.5 * (1.0 - _safe_sqrt(C_bar7 / (C_bar7 + 25.0 ** 7), eps))
    a1p = (1.0 + G) * a1
    a2p = (1.0 + G) * a2
    C1p = _safe_sqrt(a1p * a1p + b1 * b1, eps)
    C2p = _safe_sqrt(a2p * a2p + b2 * b2, eps)
    c1_zero = (a1p * a1p + b1 * b1) < 1e-10
    c2_zero = (a2p * a2p + b2 * b2) < 1e-10
    h1p = torch.where(c1_zero, torch.zeros_like(b1), _hue(b1, a1p, c1_zero))
    h2p = torch.where(c2_zero, torch.zeros_like(b2), _hue(b2, a2p, c2_zero))

    dLp = L2 - L1
    dCp = C2p - C1p
    dh = h2p - h1p
    dh = torch.where(dh > math.pi, dh - _TWO_PI, dh)
    dh = torch.where(dh < -math.pi, dh + _TWO_PI, dh)
    chroma_zero = (C1p * C2p) < 1e-8
    dh = torch.where(chroma_zero, torch.zeros_like(dh), dh)
    dHp = 2.0 * _safe_sqrt(C1p * C2p, eps) * torch.sin(dh / 2.0)

    Lp_bar = 0.5 * (L1 + L2)
    Cp_bar = 0.5 * (C1p + C2p)
    h_sum = h1p + h2p
    hp_bar = torch.where(
        (h1p - h2p).abs() > math.pi,
        torch.where(h_sum < _TWO_PI, (h_sum + _TWO_PI) / 2.0,
                    (h_sum - _TWO_PI) / 2.0),
        h_sum / 2.0)
    hp_bar = torch.where(chroma_zero, h_sum, hp_bar)
    T = (1.0 - 0.17 * torch.cos(hp_bar - math.pi / 6.0)
         + 0.24 * torch.cos(2.0 * hp_bar)
         + 0.32 * torch.cos(3.0 * hp_bar + math.pi / 30.0)
         - 0.20 * torch.cos(4.0 * hp_bar - 63.0 * math.pi / 180.0))
    d_theta = (math.pi / 6.0) * torch.exp(
        -(((hp_bar * 180.0 / math.pi - 275.0) / 25.0) ** 2))
    Cp_bar7 = Cp_bar ** 7
    R_C = 2.0 * _safe_sqrt(Cp_bar7 / (Cp_bar7 + 25.0 ** 7), eps)
    R_T = -torch.sin(2.0 * d_theta) * R_C
    Lm50sq = (Lp_bar - 50.0) ** 2
    S_L = 1.0 + 0.015 * Lm50sq / _safe_sqrt(20.0 + Lm50sq, eps)
    S_C = 1.0 + 0.045 * Cp_bar
    S_H = 1.0 + 0.015 * Cp_bar * T
    return _safe_sqrt((dLp / S_L) ** 2 + (dCp / S_C) ** 2 + (dHp / S_H) ** 2
                      + R_T * (dCp / S_C) * (dHp / S_H), eps)


def ciede2000_lab_ref_loss(lab1: torch.Tensor, lab2: torch.Tensor,
                           eps: float = 1e-6) -> torch.Tensor:
    """The reference's training-loss CIEDE2000 variant
    (``NewBP_model/losses.py:99-143``): ``eps`` inside every square root,
    no zero-chroma special cases, its own hue-mean branch."""
    L1, a1, b1 = lab1[:, 0], lab1[:, 1], lab1[:, 2]
    L2, a2, b2 = lab2[:, 0], lab2[:, 1], lab2[:, 2]
    C1 = torch.sqrt(a1 * a1 + b1 * b1 + eps)
    C2 = torch.sqrt(a2 * a2 + b2 * b2 + eps)
    Cbar7 = (0.5 * (C1 + C2)) ** 7
    G = 0.5 * (1.0 - torch.sqrt(Cbar7 / (Cbar7 + 25.0 ** 7 + eps)))
    a1p = (1.0 + G) * a1
    a2p = (1.0 + G) * a2
    C1p = torch.sqrt(a1p * a1p + b1 * b1 + eps)
    C2p = torch.sqrt(a2p * a2p + b2 * b2 + eps)
    h1p = _hue(b1, a1p, (a1p * a1p + b1 * b1) == 0.0)
    h2p = _hue(b2, a2p, (a2p * a2p + b2 * b2) == 0.0)
    dLp = L2 - L1
    dCp = C2p - C1p
    dhp = h2p - h1p
    dhp = (dhp - _TWO_PI * (dhp > math.pi).to(dhp.dtype)
           + _TWO_PI * (dhp < -math.pi).to(dhp.dtype))
    dHp = 2.0 * torch.sqrt(C1p * C2p + eps) * torch.sin(dhp / 2.0)
    Lbar = 0.5 * (L1 + L2)
    Cbarp = 0.5 * (C1p + C2p)
    hsum = h1p + h2p
    hbarp = (hsum / 2.0
             - math.pi * ((h1p - h2p).abs() > math.pi).to(hsum.dtype)
             + _TWO_PI * (hsum < 0).to(hsum.dtype))
    T = (1.0 - 0.17 * torch.cos(hbarp - math.radians(30.0))
         + 0.24 * torch.cos(2.0 * hbarp)
         + 0.32 * torch.cos(3.0 * hbarp + math.radians(6.0))
         - 0.20 * torch.cos(4.0 * hbarp - math.radians(63.0)))
    d_ro = 30.0 * torch.exp(-(((torch.rad2deg(hbarp) - 275.0) / 25.0) ** 2))
    RC = 2.0 * torch.sqrt(Cbarp ** 7 / (Cbarp ** 7 + 25.0 ** 7 + eps))
    SL = 1.0 + (0.015 * ((Lbar - 50.0) ** 2)) / torch.sqrt(
        20.0 + (Lbar - 50.0) ** 2 + eps)
    SC = 1.0 + 0.045 * Cbarp
    SH = 1.0 + 0.015 * Cbarp * T
    RT = -torch.sin(torch.deg2rad(d_ro)) * RC
    return torch.sqrt((dLp / SL) ** 2 + (dCp / SC) ** 2 + (dHp / SH) ** 2
                      + RT * (dCp / SC) * (dHp / SH) + eps)


def deltaE2000_rgb(rgb1: torch.Tensor, rgb2: torch.Tensor,
                   formula: str = "sharma") -> torch.Tensor:
    """Per-pixel CIEDE2000 map ``[N, H, W]`` between sRGB [0,1] NCHW
    images. ``formula``: ``"sharma"`` (the metric) or ``"reference_loss"``
    (the training-loss variant)."""
    lab1, lab2 = rgb_to_lab(rgb1), rgb_to_lab(rgb2)
    if formula == "reference_loss":
        return ciede2000_lab_ref_loss(lab1, lab2)
    if formula != "sharma":
        raise ValueError(
            f"formula must be 'sharma' or 'reference_loss', got {formula!r}")
    return ciede2000_lab(lab1, lab2)


def sobel_magnitude(x: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of a single-channel map ``[N, H, W]``
    (replicate padding), ``sqrt(gx^2 + gy^2 + 1e-12)``."""
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0],
                       [-1.0, 0.0, 1.0]], dtype=x.dtype, device=x.device)
    w = torch.stack([kx, kx.t()])[:, None]              # [2, 1, 3, 3]
    g = F.conv2d(F.pad(x[:, None], (1, 1, 1, 1), mode="replicate"), w)
    return torch.sqrt(g[:, 0] ** 2 + g[:, 1] ** 2 + 1e-12)
