"""Plain NewBP training loss (NCHW, fp32), the benchmark's frozen copy.

``w_l1_raw * L1(Bhat, B) + w_perc * MSE(VGG19 relu5_4) + w_deltaE *
mean CIEDE2000 + w_phys * mean |PSF(Bhat) - clamp(A * rho)|``, as the
NewBP reference (``NewBP_model/losses.py``) defines its training loss:

- VGG19 ``features[:36]`` (conv1_1 .. relu5_4, 2x2 max pools between
  stages), ImageNet normalisation of [0, 1]-clamped sRGB input, the
  target's features without gradient;
- CIEDE2000 in the reference's training-loss form (``eps`` 1e-6 inside
  every square root, no zero-chroma cases) between [0, 1]-clamped images,
  sRGB -> XYZ (D65) -> Lab;
- the physics term in sRGB: the 3x3 crosstalk PSF ``P2`` (normalised to
  unit sum, zero padding) on the [0, 1]-clamped prediction, against the
  short observation scaled by the exposure ratio and clamped to [0, 1].
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.ops import Quant, conv

VGG19_STAGES = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
P2 = ((0.01, 0.02, 0.01), (0.02, 0.88, 0.02), (0.01, 0.02, 0.01))
RGB2XYZ = ((0.412453, 0.357580, 0.180423),
           (0.212671, 0.715160, 0.072169),
           (0.019334, 0.119193, 0.950227))
D65 = (0.95047, 1.0, 1.08883)


def vgg_shapes() -> Dict[str, tuple]:
    shapes, cin = {}, 3
    for s, (feat, n) in enumerate(VGG19_STAGES, start=1):
        for i in range(1, n + 1):
            shapes[f"conv{s}_{i}.weight"] = (feat, cin, 3, 3)
            shapes[f"conv{s}_{i}.bias"] = (feat,)
            cin = feat
    return shapes


def vgg_relu5_4(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                quant: Quant = None) -> torch.Tensor:
    shape = (1, 3, 1, 1)
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    x = (x.clamp(0.0, 1.0) - mean.view(shape)) / std.view(shape)
    for s, (_, n) in enumerate(VGG19_STAGES, start=1):
        for i in range(1, n + 1):
            x = F.relu(conv(x, p[f"conv{s}_{i}.weight"],
                            p[f"conv{s}_{i}.bias"], quant, padding=1))
        if s < len(VGG19_STAGES):
            x = F.max_pool2d(x, 2)
    return x


def srgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    lin = torch.where(rgb > 0.04045,
                      ((rgb + 0.055) / 1.055).clamp(min=1e-12) ** 2.4,
                      rgb / 12.92)
    m = torch.tensor(RGB2XYZ, dtype=rgb.dtype, device=rgb.device)
    xyz = torch.einsum("dc,nchw->ndhw", m, lin)
    white = torch.tensor(D65, dtype=rgb.dtype, device=rgb.device)
    t = xyz / white.view(1, 3, 1, 1)
    d = 6.0 / 29.0
    f = torch.where(t > d ** 3, t.clamp(min=1e-12) ** (1.0 / 3.0),
                    t / (3.0 * d * d) + 4.0 / 29.0)
    return torch.stack([116.0 * f[:, 1] - 16.0, 500.0 * (f[:, 0] - f[:, 1]),
                        200.0 * (f[:, 1] - f[:, 2])], 1)


def _hue(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    zero = (a * a + b * b) == 0.0
    h = torch.atan2(torch.where(zero, torch.zeros_like(b), b),
                    torch.where(zero, torch.ones_like(a), a))
    return torch.remainder(h, 2.0 * math.pi)


def ciede2000_loss_form(lab1: torch.Tensor, lab2: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    L1, a1, b1 = lab1.unbind(1)
    L2, a2, b2 = lab2.unbind(1)
    C1 = torch.sqrt(a1 * a1 + b1 * b1 + eps)
    C2 = torch.sqrt(a2 * a2 + b2 * b2 + eps)
    cb7 = (0.5 * (C1 + C2)) ** 7
    G = 0.5 * (1.0 - torch.sqrt(cb7 / (cb7 + 25.0 ** 7 + eps)))
    a1p, a2p = (1.0 + G) * a1, (1.0 + G) * a2
    C1p = torch.sqrt(a1p * a1p + b1 * b1 + eps)
    C2p = torch.sqrt(a2p * a2p + b2 * b2 + eps)
    h1p, h2p = _hue(b1, a1p), _hue(b2, a2p)
    dL, dC = L2 - L1, C2p - C1p
    dh = h2p - h1p
    dh = dh - 2 * math.pi * (dh > math.pi).to(dh.dtype) \
        + 2 * math.pi * (dh < -math.pi).to(dh.dtype)
    dH = 2.0 * torch.sqrt(C1p * C2p + eps) * torch.sin(dh / 2.0)
    Lbar, Cbar = 0.5 * (L1 + L2), 0.5 * (C1p + C2p)
    hsum = h1p + h2p
    hbar = hsum / 2.0 - math.pi * ((h1p - h2p).abs() > math.pi).to(
        hsum.dtype) + 2 * math.pi * (hsum < 0).to(hsum.dtype)
    T = (1.0 - 0.17 * torch.cos(hbar - math.radians(30.0))
         + 0.24 * torch.cos(2.0 * hbar)
         + 0.32 * torch.cos(3.0 * hbar + math.radians(6.0))
         - 0.20 * torch.cos(4.0 * hbar - math.radians(63.0)))
    d_ro = 30.0 * torch.exp(-(((torch.rad2deg(hbar) - 275.0) / 25.0) ** 2))
    RC = 2.0 * torch.sqrt(Cbar ** 7 / (Cbar ** 7 + 25.0 ** 7 + eps))
    SL = 1.0 + 0.015 * (Lbar - 50.0) ** 2 / torch.sqrt(
        20.0 + (Lbar - 50.0) ** 2 + eps)
    SC = 1.0 + 0.045 * Cbar
    SH = 1.0 + 0.015 * Cbar * T
    RT = -torch.sin(torch.deg2rad(d_ro)) * RC
    return torch.sqrt((dL / SL) ** 2 + (dC / SC) ** 2 + (dH / SH) ** 2
                      + RT * (dC / SC) * (dH / SH) + eps)


def psf_p2(x: torch.Tensor) -> torch.Tensor:
    k = torch.tensor(P2, dtype=x.dtype, device=x.device)
    k = (k / k.sum()).expand(x.shape[1], 3, 3)[:, None]
    return F.conv2d(F.pad(x, (1, 1, 1, 1)), k, groups=x.shape[1])


def newbp_loss(out: torch.Tensor, batch: Mapping[str, torch.Tensor],
               vgg: Mapping[str, torch.Tensor], weights: Mapping[str, float],
               quant: Quant = None) -> Tuple[torch.Tensor,
                                             Dict[str, torch.Tensor]]:
    """``(total, terms)`` of one batch. ``batch`` holds NCHW ``gt`` (the
    long exposure B), ``short`` (the observation A) and ``ratio`` [N]."""
    gt, short = batch["gt"], batch["short"]
    rho = batch["ratio"].view(-1, 1, 1, 1)
    out01, gt01 = out.clamp(0.0, 1.0), gt.clamp(0.0, 1.0)
    terms: Dict[str, torch.Tensor] = {"l1_raw": (out - gt).abs().mean()}
    if weights.get("perc"):
        fp = vgg_relu5_4(out01, vgg, quant)
        with torch.no_grad():
            ft = vgg_relu5_4(gt01, vgg, quant)
        terms["perc"] = ((fp - ft) ** 2).mean()
    if weights.get("deltaE"):
        terms["deltaE"] = ciede2000_loss_form(srgb_to_lab(out01),
                                              srgb_to_lab(gt01)).mean()
    if weights.get("phys"):
        aligned = (short.clamp(0.0, 1.0) * rho).clamp(0.0, 1.0)
        terms["phys"] = (psf_p2(out01) - aligned).abs().mean()
    total = sum(weights[k] * v for k, v in terms.items())
    return total, terms


def loss_weights(train_opt: Mapping) -> Dict[str, float]:
    """The term weights a config's ``train.hybrid_opt`` switches on."""
    h = train_opt["hybrid_opt"]
    w = {"l1_raw": float(h.get("w_l1_raw", 1.0))}
    for key, use in (("perc", "use_perc"), ("deltaE", "use_deltaE"),
                     ("phys", "use_phys")):
        if h.get(use, True):
            w[key] = float(h[f"w_{key}"])
    for unsupported in ("use_ssim", "use_lpips", "use_uncertainty"):
        if h.get(unsupported):
            raise ValueError(f"the reference loss has no {unsupported}")
    phys = h.get("physics") or {}
    if (phys.get("domain", "srgb"), phys.get("mode", "mono"),
            phys.get("kernel_spec", "P2")) != ("srgb", "mono", "P2"):
        raise ValueError("the reference loss has the sRGB P2 physics term "
                         "only")
    return w
