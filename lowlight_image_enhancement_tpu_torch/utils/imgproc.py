"""Small host-side image ops replacing the reference's cv2 calls.

The port's own copy of ``lowlight_image_enhancement_tpu/utils/
imgproc.py`` (numpy/scipy, cv2 where importable).

The face-restoration pipeline (reference
``NAFNet_base/basicsr/utils/face_util.py:139-215``) needs four cv2
primitives: ``warpAffine``, ``resize`` (bilinear), ``erode`` and
``GaussianBlur``. OpenCV is not a baked-in dependency of this framework,
so these are implemented in numpy/scipy with cv2-matched conventions:

- :func:`warp_affine` — ``M`` maps src->dst (cv2 convention); output
  pixels sample the source at ``M^-1`` with bilinear interpolation and
  constant-0 border.
- :func:`resize_bilinear` — cv2's half-pixel-centre source mapping.
- :func:`erode` — minimum filter with a ``k x k`` ones kernel; borders
  replicate (cv2's default morphology border treats outside as +inf,
  which for erosion is equivalent on the mask interiors used here).
- :func:`gaussian_blur` — cv2's ``getGaussianKernel`` coefficients
  (including the sigma-from-ksize formula used when ``sigma=0``) with
  reflect-101 borders.

When cv2 *is* importable these delegate to it, so behaviour is identical
in both environments.
"""

from __future__ import annotations

import os

import numpy as np


_CV2_MOD = None
_CV2_TRIED = False


def _cv2():
    # Env var re-read per call (tests toggle it); the import probe is
    # cached because Python does not cache FAILED imports and this runs
    # several times per face on the cv2-less path.
    if os.environ.get("LLIE_NO_CV2"):
        return None
    global _CV2_MOD, _CV2_TRIED
    if not _CV2_TRIED:
        _CV2_TRIED = True
        try:
            import cv2

            _CV2_MOD = cv2
        except ImportError:
            _CV2_MOD = None
    return _CV2_MOD


def warp_affine(img: np.ndarray, M: np.ndarray,
                out_size: "tuple[int, int]") -> np.ndarray:
    """cv2.warpAffine: ``out_size`` is ``(width, height)``; ``M`` is the
    2x3 src->dst transform; bilinear sampling, constant-0 border."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.warpAffine(img, np.asarray(M, np.float64), out_size)
    w_out, h_out = int(out_size[0]), int(out_size[1])
    M = np.asarray(M, np.float64)
    A, t = M[:, :2], M[:, 2]
    Ainv = np.linalg.inv(A)
    xs, ys = np.meshgrid(np.arange(w_out), np.arange(h_out))
    src = np.stack([xs, ys], axis=-1) - t  # [H,W,2] in (x, y)
    sx = Ainv[0, 0] * src[..., 0] + Ainv[0, 1] * src[..., 1]
    sy = Ainv[1, 0] * src[..., 0] + Ainv[1, 1] * src[..., 1]

    h, w = img.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None] if img.ndim == 3 else (sx - x0)
    fy = (sy - y0)[..., None] if img.ndim == 3 else (sy - y0)

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(
            np.float64)
        mask = valid[..., None] if img.ndim == 3 else valid
        return v * mask

    out = (tap(y0, x0) * (1 - fx) * (1 - fy)
           + tap(y0, x0 + 1) * fx * (1 - fy)
           + tap(y0 + 1, x0) * (1 - fx) * fy
           + tap(y0 + 1, x0 + 1) * fx * fy)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(img.dtype)


def resize_bilinear(img: np.ndarray,
                    out_size: "tuple[int, int]") -> np.ndarray:
    """cv2.resize with INTER_LINEAR: ``out_size`` is ``(width, height)``;
    half-pixel-centre source coordinates, edge clamped."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, out_size)
    w_out, h_out = int(out_size[0]), int(out_size[1])
    h, w = img.shape[:2]
    sx = (np.arange(w_out) + 0.5) * (w / w_out) - 0.5
    sy = (np.arange(h_out) + 0.5) * (h / h_out) - 0.5
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx, fy = sx - x0, sy - y0

    def cx(v):
        return np.clip(v, 0, w - 1)

    def cy(v):
        return np.clip(v, 0, h - 1)

    g = img.astype(np.float64)
    wfx = fx[None, :, None] if img.ndim == 3 else fx[None, :]
    wfy = fy[:, None, None] if img.ndim == 3 else fy[:, None]
    top = g[cy(y0)][:, cx(x0)] * (1 - wfx) + g[cy(y0)][:, cx(x0 + 1)] * wfx
    bot = (g[cy(y0 + 1)][:, cx(x0)] * (1 - wfx)
           + g[cy(y0 + 1)][:, cx(x0 + 1)] * wfx)
    out = top * (1 - wfy) + bot * wfy
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(img.dtype)


def erode(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.erode with a ``ksize x ksize`` ones kernel (minimum filter)."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.erode(img, np.ones((ksize, ksize), np.uint8))
    from scipy import ndimage

    size = (ksize, ksize) + (1,) * (img.ndim - 2)
    # scipy's origin=0 window [i - k//2, i + k - 1 - k//2] matches cv2's
    # default anchor (k//2, k//2) for both odd and even kernels
    return ndimage.minimum_filter(img, size=size, mode="nearest")


_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125]),
}


def _cv2_gaussian_kernel(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma=0): fixed binomial taps for
    ksize <= 7 (OpenCV's small_gaussian_tab), else sigma derived from
    ksize."""
    if ksize in _SMALL_GAUSSIAN_TAB:
        return _SMALL_GAUSSIAN_TAB[ksize]
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), 0): separable Gaussian with
    the ksize-derived sigma and reflect-101 border."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.GaussianBlur(img, (ksize, ksize), 0)
    from scipy import ndimage

    k = _cv2_gaussian_kernel(ksize)
    out = img.astype(np.float64)
    out = ndimage.correlate1d(out, k, axis=0, mode="mirror")
    out = ndimage.correlate1d(out, k, axis=1, mode="mirror")
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(img.dtype)
