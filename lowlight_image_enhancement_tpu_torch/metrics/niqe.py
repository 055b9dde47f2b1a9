"""NIQE no-reference quality metric (stock BasicSR parity).

A numpy/scipy copy of ``lowlight_image_enhancement_tpu/metrics/niqe.py``
(reference ``basicsr/metrics/niqe.py:17-212``): MSCN coefficients ->
asymmetric-GGD feature fits per 96x96 block at two scales -> the
Mahalanobis-style distance to a pristine multivariate-Gaussian model. The
first two features are an AGGD fit of the MSCN map (``alpha, (beta_l +
beta_r)/2``, ``niqe.py:57-58``), then four pairwise-product AGGD fits; a
block with no sample on one side gives NaN features that drop out of the
fit (``nanmean``, NaN-filtered covariance), as in the reference.

The pristine models are data: the JAX package's
``lowlight_image_enhancement_tpu/weights/niqe_pris_params*.npz`` (the
reference's MATLAB-official fit, and the photo and synthetic corpus fits
of ``tools/make_niqe_params.py``) are read in place, as files; nothing of
that package is imported. ``$LLIE_NIQE_PARAMS`` or a path argument
selects another fit. :func:`calculate_niqe` takes an HWC (or HW) numpy
image as the JAX function does, or a CHW (or HW) tensor from any device.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.ndimage import convolve
from scipy.special import gamma

from lowlight_image_enhancement_tpu_torch.metrics.psnr import host_array
from lowlight_image_enhancement_tpu_torch.metrics.psnr_ssim_img import (
    rgb2ycbcr,
)

# the pristine-model files beside the JAX package's modules (data only)
PRIS_DIR = (Path(__file__).resolve().parents[2]
            / "lowlight_image_enhancement_tpu" / "weights")

_GAM_GRID = np.arange(0.2, 10.001, 0.001)  # len 9801, reference niqe.py:28


def _estimate_ggd(block: np.ndarray) -> Tuple[float, float]:
    """Fit a generalized Gaussian distribution; returns (alpha, sigma^2).

    Kept for the original-paper parameterization (the NIQE paper's Eq. 2
    uses a GGD for the first two features); the reference's *shipped*
    implementation — and therefore :func:`compute_niqe_features` — uses
    an AGGD fit instead (``basicsr/metrics/niqe.py:57-58``)."""
    r_gam = (gamma(1.0 / _GAM_GRID) * gamma(3.0 / _GAM_GRID)) / (
        gamma(2.0 / _GAM_GRID) ** 2)
    sigma_sq = float(np.mean(block**2))
    sigma = math.sqrt(sigma_sq) if sigma_sq > 0 else 1e-12
    E = float(np.mean(np.abs(block)))
    rho = sigma_sq / (E**2 + 1e-12)
    alpha = _GAM_GRID[np.argmin(np.abs(rho - r_gam))]
    return float(alpha), sigma_sq


def _estimate_aggd(block: np.ndarray) -> Tuple[float, float, float]:
    """Fit an asymmetric GGD; returns (alpha, beta_l, beta_r).

    Reference semantics (``basicsr/metrics/niqe.py:17-44``): no epsilon
    floors — a block with no negative (or no positive) samples yields a
    NaN std, propagating NaN features that the MVG fit then drops row-wise
    (``nanmean`` + nan-filtered cov). Warnings from the empty-slice mean
    are suppressed, matching numpy's value behavior in the reference."""
    block = block.flatten()
    r_gam = (gamma(2.0 / _GAM_GRID) ** 2) / (
        gamma(1.0 / _GAM_GRID) * gamma(3.0 / _GAM_GRID))
    with np.errstate(invalid="ignore", divide="ignore"):
        left_std = np.sqrt(np.mean(block[block < 0] ** 2))
        right_std = np.sqrt(np.mean(block[block > 0] ** 2))
        gamma_hat = left_std / right_std
        rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block**2)
        rhat_norm = (rhat * (gamma_hat**3 + 1) * (gamma_hat + 1)) / (
            (gamma_hat**2 + 1) ** 2)
        # Plain argmin on purpose: for a NaN rhat_norm (one-signed block)
        # numpy returns index 0 -> alpha = 0.2 with NaN betas, exactly
        # the reference's behavior (niqe.py:39-43); the NaN betas then
        # drop the row from the MVG fit.
        alpha = _GAM_GRID[np.argmin((r_gam - rhat_norm) ** 2)]
        const = np.sqrt(gamma(1.0 / alpha) / gamma(3.0 / alpha))
        beta_l = left_std * const
        beta_r = right_std * const
    return float(alpha), float(beta_l), float(beta_r)


def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    """MATLAB ``fspecial('gaussian', size, sigma)`` (normalized); the
    reference ships this same window inside its npz (verified equal to
    ~1e-17)."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2 * sigma**2))
    w = np.outer(g, g)
    return w / w.sum()


def compute_niqe_features(img: np.ndarray) -> np.ndarray:
    """18 NIQE features of one MSCN block: AGGD fit of the block itself
    (``alpha, (beta_l+beta_r)/2``) + 4 pairwise-shift AGGD fits
    (reference ``niqe.py:47-71``)."""
    features = []
    alpha, beta_l, beta_r = _estimate_aggd(img)
    features.extend([alpha, (beta_l + beta_r) / 2.0])
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    for dy, dx in shifts:
        shifted = np.roll(img, (dy, dx), axis=(0, 1))
        alpha, beta_l, beta_r = _estimate_aggd(img * shifted)
        with np.errstate(invalid="ignore"):
            mean = (beta_r - beta_l) * (
                gamma(2.0 / alpha) / gamma(1.0 / alpha))
        features.extend([alpha, mean, beta_l, beta_r])
    return np.asarray(features)


def _mscn(img: np.ndarray,
          window: Optional[np.ndarray] = None) -> np.ndarray:
    win = _gaussian_window() if window is None else window
    mu = convolve(img, win, mode="nearest")
    sigma = np.sqrt(np.abs(
        convolve(img * img, win, mode="nearest") - mu * mu
    ))
    return (img - mu) / (sigma + 1.0)


def _load_pris_params(path: Optional[str]):
    """Search order: explicit path -> $LLIE_NIQE_PARAMS -> the BUNDLED
    **reference/MATLAB-official** fit (``weights/niqe_pris_params.npz``,
    copied from the reference's data file — value-comparable with the
    reference implementation) -> the bundled real-photo-corpus fit ->
    the bundled synthetic-corpus fit (both from
    ``tools/make_niqe_params.py``; self-consistent but not comparable to
    MATLAB-fit scores). Use :func:`niqe_model_info` to see which model
    (and corpus) is active."""
    mu, cov, win, _ = _load_pris_params_info(path)
    return mu, cov, win


def _load_pris_params_info(path: Optional[str]):
    candidates = (
        path,
        os.environ.get("LLIE_NIQE_PARAMS"),
        str(PRIS_DIR / "niqe_pris_params.npz"),
        str(PRIS_DIR / "niqe_pris_params_photo.npz"),
        str(PRIS_DIR / "niqe_pris_params_synthetic.npz"),
    )
    for cand in candidates:
        if cand and os.path.exists(cand):
            data = np.load(cand)
            if "corpus" in data:
                corpus = str(data["corpus"])
            elif os.path.basename(cand) == "niqe_pris_params.npz":
                corpus = "matlab_official_reference"
            else:
                corpus = "unknown"
            window = (np.asarray(data["gaussian_window"])
                      if "gaussian_window" in data else None)
            return (data["mu_pris_param"], data["cov_pris_param"], window,
                    {"path": os.path.abspath(cand), "corpus": corpus})
    raise FileNotFoundError(
        "NIQE pristine-model parameters not found: provide "
        "niqe_pris_params.npz via the `pris_params_path` argument or "
        "$LLIE_NIQE_PARAMS (the reference ships this data file; the NIQE "
        "math itself is fully implemented here)."
    )


def niqe_model_info(pris_params_path: Optional[str] = None) -> dict:
    """Provenance of the pristine model :func:`calculate_niqe` would use:
    ``{'path': ..., 'corpus': ...}`` (corpus tag written by
    ``tools/make_niqe_params.py``; ``matlab_official_reference`` for the
    bundled reference fit). Scores are only comparable within one
    pristine model."""
    return _load_pris_params_info(pris_params_path)[3]


def calculate_niqe(
    img,
    crop_border: int = 0,
    pris_params_path: Optional[str] = None,
    block_size: int = 96,
    convert_to: str = "y",
) -> float:
    """NIQE score (lower = better perceptual quality).

    ``img``: grayscale HW or **RGB** HWC numpy, or a CHW / HW tensor
    (this framework is RGB-order end to end; the reference's entry takes
    BGR -- ``niqe.py:165-204`` -- and converts with the same MATLAB YCbCr
    math), range [0, 255] or [0, 1] (auto-promoted). ``convert_to``: ``'y'`` = MATLAB YCbCr Y
    channel (reference default), ``'gray'`` = BT.601 luma.

    Matches the reference pipeline: float32 image, per-scale MSCN with
    the pristine model's Gaussian window, 96x96 blocks (indexed /scale at
    scale 2), bilinear 2x downsample between scales (exactly the 2x2 box
    mean for even sizes on the float path), nanmean/nan-filtered-cov MVG
    fit, pinv Mahalanobis distance (``niqe.py:74-162``)."""
    mu_pris, cov_pris, window = _load_pris_params(pris_params_path)

    if isinstance(img, torch.Tensor) and img.dim() == 3:
        img = img.permute(1, 2, 0)  # CHW -> HWC
    img = host_array(img, np.float32)
    if img.max() <= 2.0:
        img = img * 255.0
    if img.ndim == 3 and img.shape[-1] == 3:
        if convert_to == "y":
            img = rgb2ycbcr(img / 255.0, y_only=True) * 255.0
        elif convert_to == "gray":
            img = np.dot(img, [0.299, 0.587, 0.114])
        else:
            raise ValueError("convert_to must be 'y' or 'gray'")
        img = np.squeeze(img).astype(np.float32)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]

    h, w = img.shape
    nb_h, nb_w = h // block_size, w // block_size
    if nb_h == 0 or nb_w == 0:
        raise ValueError(f"image {img.shape} smaller than one "
                         f"{block_size}x{block_size} block")
    img = img[: nb_h * block_size, : nb_w * block_size]

    feats_all = []
    for scale in (1, 2):
        mscn = _mscn(img, window)
        bs = block_size // scale
        feats = [
            compute_niqe_features(
                mscn[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs]
            )
            for i in range(nb_h)
            for j in range(nb_w)
        ]
        feats_all.append(np.stack(feats))
        if scale == 1:
            # Bilinear 2x downsample — for even sizes on the float path
            # this equals the 2x2 box mean, which is exactly what the
            # reference's cv2.resize(INTER_LINEAR, 0.5x) computes
            # (niqe.py:141-145; the /255,*255 round trip is fp32-lossy
            # there, covered by the parity test tolerance).
            img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                          + img[0::2, 1::2] + img[1::2, 1::2])
    features = np.concatenate(feats_all, axis=1)

    with np.errstate(invalid="ignore"):
        mu_dist = np.nanmean(features, axis=0)
    valid = features[~np.isnan(features).any(axis=1)]
    cov_dist = np.cov(valid, rowvar=False)
    cov_avg = (cov_pris + cov_dist) / 2.0
    diff = (np.asarray(mu_pris).reshape(-1) - mu_dist)[None]
    quality = diff @ np.linalg.pinv(cov_avg) @ diff.T
    return float(np.sqrt(max(quality[0, 0], 0.0)))
