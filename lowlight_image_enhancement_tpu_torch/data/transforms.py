"""Image transforms for paired restoration data (host-side NumPy, NHWC).

The port's copy of ``lowlight_image_enhancement_tpu/data/transforms.py``
(rebuild of reference ``basicsr/data/transforms.py:12-246`` and the image
utilities of ``basicsr/utils/img_util.py:15-186``): joint paired crops,
flip/rot augmentation, mod-crop, 16-bit PNG decode, float conversion. The
same numpy RNG calls in the same order, so a seeded generator gives the
same crops and flips as the JAX package's. All functions take HWC numpy
arrays (single images) or lists of them; the loader's prefetcher moves
batches to the device and to NCHW.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

Img = np.ndarray


def _as_list(x) -> Tuple[List[Img], bool]:
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def paired_random_crop(
    imgs_gt: Union[Img, Sequence[Img]],
    imgs_lq: Union[Img, Sequence[Img]],
    patch_size: int,
    scale: int = 1,
    rng: Optional[np.random.Generator] = None,
):
    """Joint random crop of gt (patch*scale) and lq (patch) images.

    All arrays HWC; gt spatial dims must be ``scale`` x the lq dims.
    """
    rng = rng or np.random.default_rng()
    gts, gt_was_list = _as_list(imgs_gt)
    lqs, lq_was_list = _as_list(imgs_lq)
    h_lq, w_lq = lqs[0].shape[:2]
    h_gt, w_gt = gts[0].shape[:2]
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(
            f"gt size {(h_gt, w_gt)} is not {scale}x lq size {(h_lq, w_lq)}"
        )
    if h_lq < patch_size or w_lq < patch_size:
        raise ValueError(
            f"lq {(h_lq, w_lq)} smaller than patch {patch_size}"
        )
    top = int(rng.integers(0, h_lq - patch_size + 1))
    left = int(rng.integers(0, w_lq - patch_size + 1))
    lqs = [im[top : top + patch_size, left : left + patch_size, ...]
           for im in lqs]
    tg, lg, pg = top * scale, left * scale, patch_size * scale
    gts = [im[tg : tg + pg, lg : lg + pg, ...] for im in gts]
    return (gts if gt_was_list else gts[0],
            lqs if lq_was_list else lqs[0])


def paired_random_crop_hw(
    imgs_gt: Union[Img, Sequence[Img]],
    imgs_lq: Union[Img, Sequence[Img]],
    gt_patch_h: int,
    gt_patch_w: int,
    scale: int = 1,
    rng: Optional[np.random.Generator] = None,
):
    """Rectangular joint random crop (reference
    ``basicsr/data/transforms.py:94-160 paired_random_crop_hw``): the lq
    patch is ``(gt_patch_h//scale, gt_patch_w//scale)`` at a shared random
    location, the gt patch the scaled window."""
    rng = rng or np.random.default_rng()
    gts, gt_was_list = _as_list(imgs_gt)
    lqs, lq_was_list = _as_list(imgs_lq)
    h_lq, w_lq = lqs[0].shape[:2]
    ph, pw = gt_patch_h // scale, gt_patch_w // scale
    if h_lq < ph or w_lq < pw:
        raise ValueError(f"lq {(h_lq, w_lq)} smaller than patch {(ph, pw)}")
    top = int(rng.integers(0, h_lq - ph + 1))
    left = int(rng.integers(0, w_lq - pw + 1))
    lqs = [im[top : top + ph, left : left + pw, ...] for im in lqs]
    tg, lg = top * scale, left * scale
    gts = [im[tg : tg + gt_patch_h, lg : lg + gt_patch_w, ...]
           for im in gts]
    return (gts if gt_was_list else gts[0],
            lqs if lq_was_list else lqs[0])


def pad_to_min_size(img_lq: Img, img_gt: Img, gt_size: int,
                    scale: int = 1):
    """Reflect-pad (bottom/right) so lq reaches at least
    ``gt_size//scale`` and gt at least ``gt_size`` per spatial dim.

    Reference ``img_util.py:133-145 padding`` pads BOTH images by the
    same pixel amounts, which silently breaks the ``gt = scale*lq``
    relation whenever ``scale != 1``; padding each image to its own
    scaled target preserves it (the crop that follows asserts it)."""

    def _pad(img: Img, target: int) -> Img:
        h, w = img.shape[:2]
        h_pad, w_pad = max(0, target - h), max(0, target - w)
        if h_pad == 0 and w_pad == 0:
            return img
        pad = ((0, h_pad), (0, w_pad)) + ((0, 0),) * (img.ndim - 2)
        return np.pad(img, pad, mode="reflect")

    return _pad(img_lq, gt_size // scale), _pad(img_gt, gt_size)


def center_crop(img: Img, patch_size: int) -> Img:
    h, w = img.shape[:2]
    top = max((h - patch_size) // 2, 0)
    left = max((w - patch_size) // 2, 0)
    return img[top : top + patch_size, left : left + patch_size, ...]


def joint_random_crop(
    imgs: Sequence[Img], patch_size: int,
    rng: Optional[np.random.Generator] = None,
) -> List[Img]:
    """Crop N same-sized images at the same random location (the SID
    dataset crops short/long/raw/obs jointly,
    ``sony_sid_lmdb_dataset.py:161-194``)."""
    rng = rng or np.random.default_rng()
    h, w = imgs[0].shape[:2]
    for im in imgs[1:]:
        if im.shape[:2] != (h, w):
            raise ValueError("joint crop requires equal spatial dims")
    if h < patch_size or w < patch_size:
        raise ValueError(f"images {(h, w)} smaller than patch {patch_size}")
    top = int(rng.integers(0, h - patch_size + 1))
    left = int(rng.integers(0, w - patch_size + 1))
    return [im[top : top + patch_size, left : left + patch_size, ...]
            for im in imgs]


def augment_draws(
    rng: np.random.Generator, hflip: bool = True, rotation: bool = True,
    vflip: Optional[bool] = None,
) -> Tuple[bool, bool, bool]:
    """The ``(hflip, vflip, rot90)`` choices :func:`augment` draws from
    ``rng``, in its order (a data set draws them ahead of its loads)."""
    do_hflip = hflip and rng.random() < 0.5
    do_vflip = (vflip if vflip is not None else rotation) \
        and rng.random() < 0.5
    do_rot = rotation and rng.random() < 0.5
    return do_hflip, do_vflip, do_rot


def apply_augment(img: Img, status: Tuple[bool, bool, bool]) -> Img:
    """One image flipped and transposed by ``(hflip, vflip, rot90)``."""
    do_hflip, do_vflip, do_rot = status
    if do_hflip:
        img = img[:, ::-1, ...]
    if do_vflip:
        img = img[::-1, :, ...]
    if do_rot:
        img = np.transpose(img, (1, 0, 2)) if img.ndim == 3 else img.T
    return np.ascontiguousarray(img)


def augment(
    imgs: Union[Img, Sequence[Img]],
    hflip: bool = True,
    rotation: bool = True,
    rng: Optional[np.random.Generator] = None,
    vflip: Optional[bool] = None,
    return_status: bool = False,
):
    """Random horizontal flip / vertical flip / transpose ("rot90"),
    applied identically to all images (reference ``augment``,
    ``basicsr/data/transforms.py:163-218``): ``vflip`` (when given)
    decouples the vertical flip from ``rotation`` and ``return_status``
    appends the drawn ``(hflip, vflip, rot90)`` tuple — the stereo
    dataset's calling convention."""
    rng = rng or np.random.default_rng()
    status = augment_draws(rng, hflip, rotation, vflip)
    lst, was_list = _as_list(imgs)
    out = [apply_augment(im, status) for im in lst]
    out = out if was_list else out[0]
    if return_status:
        return out, status
    return out


def mod_crop(img: Img, scale: int) -> Img:
    """Crop spatial dims to multiples of ``scale``."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def decode_png_uint16(buf: bytes) -> Img:
    """Decode a (possibly 16-bit) PNG byte buffer to RGB uint16 HWC.

    Mirrors reference ``_load_png_uint16`` (``sony_sid_lmdb_dataset.py:
    38-56``): uint8 images are promoted x257 to the uint16 scale. Decodes
    via the port's :mod:`..utils.imgio` (zlib inflate, C defilter), which returns
    RGB directly — no BGR swap needed here.
    """
    from lowlight_image_enhancement_tpu_torch.utils import imgio

    img = imgio.imdecode(bytes(buf))
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.dtype == np.uint8:
        img = img.astype(np.uint16) * 257
    return np.ascontiguousarray(img[..., :3])


def uint16_to_float01(img: Img) -> Img:
    """uint16 [0, 65535] -> float32 [0, 1]."""
    return (img.astype(np.float32) / 65535.0).clip(0.0, 1.0)
