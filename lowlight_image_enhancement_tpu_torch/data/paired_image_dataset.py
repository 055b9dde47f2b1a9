"""Generic paired / single image-folder datasets (stock BasicSR layer).

Counterpart of ``lowlight_image_enhancement_tpu/data/paired_image_dataset.py``
(reference ``basicsr/data/paired_image_dataset.py``,
``single_image_dataset.py``, ``ffhq_dataset.py``), with the same numpy
draws in the same order, so a seed gives the JAX package's items bit for
bit:

- :class:`PairedImageDataset` -- ``dataroot_gt`` / ``dataroot_lq`` paired
  by file stem (or by a ``meta_info`` file); train phase:
  ``paired_random_crop`` + flip / rotation; items ``{lq, gt, lq_path,
  gt_path}``, float32 [0, 1] HWC;
- :class:`SingleImageDataset` -- an lq-only folder for blind inference;
- :func:`paired_paths_from_meta_info_file` -- BasicSR ``meta_info/*.txt``
  pairing: one GT name per line, the LQ name from ``filename_tmpl``;
- :class:`FFHQDataset` -- GT-only, mean/std normalised, optional h-flip.

Images are read by the port's :mod:`..utils.imgio` (RGB); the loader's
device prefetcher moves the numeric arrays to the card, NCHW.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from lowlight_image_enhancement_tpu_torch.data.transforms import (
    augment,
    paired_random_crop,
)
from lowlight_image_enhancement_tpu_torch.utils import imgio
from lowlight_image_enhancement_tpu_torch.utils.registry import (
    DATASET_REGISTRY,
)

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def _scan(folder: str) -> Dict[str, str]:
    """``{stem: path}`` of the image files in ``folder``, by sorted name."""
    out = {}
    for name in sorted(os.listdir(folder)):
        stem, ext = os.path.splitext(name)
        if ext.lower() in _EXTS:
            out[stem] = os.path.join(folder, name)
    return out


def _read_float01(path: str) -> np.ndarray:
    """An image file -> float32 [0, 1] HWC with at most 3 channels."""
    img = imgio.imread(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] >= 3:
        img = img[..., :3]
    return np.ascontiguousarray(imgio.to_float01(img))


def paired_paths_from_meta_info_file(dataroot_lq: str, dataroot_gt: str,
                                     meta_info_file: str,
                                     filename_tmpl: str = "{}"):
    """``[(lq_path, gt_path)]`` from a BasicSR ``meta_info`` file: each
    line's first whitespace-separated token is a GT file name (e.g.
    ``0001_s001.png (480,480,3)``); the LQ name is
    ``filename_tmpl.format(stem) + ext``."""
    with open(meta_info_file) as fin:
        gt_names = [line.strip().split(" ")[0] for line in fin
                    if line.strip()]
    pairs = []
    for gt_name in gt_names:
        stem, ext = os.path.splitext(gt_name)
        lq_name = f"{filename_tmpl.format(stem)}{ext}"
        pairs.append((os.path.join(dataroot_lq, lq_name),
                      os.path.join(dataroot_gt, gt_name)))
    return pairs


@DATASET_REGISTRY.register()
class PairedImageDataset:
    def __init__(self, dataroot_gt: str, dataroot_lq: str,
                 phase: str = "train", gt_size: Optional[int] = None,
                 scale: int = 1, use_flip: bool = True, use_rot: bool = True,
                 seed: int = 0, meta_info_file: Optional[str] = None,
                 filename_tmpl: str = "{}", **_ignored: Any):
        if meta_info_file:
            self.pairs = paired_paths_from_meta_info_file(
                dataroot_lq, dataroot_gt, meta_info_file, filename_tmpl)
        else:
            gt_map = _scan(dataroot_gt)
            lq_map = _scan(dataroot_lq)
            stems = sorted(set(gt_map) & set(lq_map))
            if not stems:
                raise ValueError(f"no paired images between {dataroot_gt} "
                                 f"and {dataroot_lq}")
            self.pairs = [(lq_map[s], gt_map[s]) for s in stems]
        self.phase = phase
        self.gt_size = gt_size
        self.scale = scale
        self.use_flip = use_flip
        self.use_rot = use_rot
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        lq_path, gt_path = self.pairs[idx % len(self.pairs)]
        lq = _read_float01(lq_path)
        gt = _read_float01(gt_path)
        if self.phase == "train" and self.gt_size:
            gt, lq = paired_random_crop(gt, lq, self.gt_size // self.scale,
                                        self.scale, rng=self._rng)
            gt, lq = augment([gt, lq], hflip=self.use_flip,
                             rotation=self.use_rot, rng=self._rng)
        return {"lq": lq, "gt": gt, "lq_path": lq_path, "gt_path": gt_path}


@DATASET_REGISTRY.register()
class FFHQDataset:
    """GT-only face dataset (reference ``ffhq_dataset.py:15-72``):
    ``dataroot_gt`` holds ``{i:08d}.png`` (or pass ``meta_info_file`` /
    ``num_images``); items ``{gt, gt_path}``, gt float32 HWC normalised by
    ``mean`` / ``std`` and optionally h-flipped. ``num_images`` defaults to
    the images present."""

    def __init__(self, dataroot_gt: str, mean=(0.5, 0.5, 0.5),
                 std=(0.5, 0.5, 0.5), use_hflip: bool = False,
                 num_images: Optional[int] = None,
                 meta_info_file: Optional[str] = None, seed: int = 0,
                 **_ignored: Any):
        if meta_info_file:
            with open(meta_info_file) as fin:
                names = [line.strip().split(" ")[0] for line in fin
                         if line.strip()]
            self.paths = [os.path.join(dataroot_gt, n) for n in names]
        elif num_images is not None:
            self.paths = [os.path.join(dataroot_gt, f"{v:08d}.png")
                          for v in range(num_images)]
        else:
            scanned = _scan(dataroot_gt)
            self.paths = [scanned[s] for s in sorted(scanned)]
        if not self.paths:
            raise ValueError(f"no images under {dataroot_gt}")
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.use_hflip = use_hflip
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        path = self.paths[idx % len(self.paths)]
        gt = _read_float01(path)
        if self.use_hflip and self._rng.random() < 0.5:
            gt = gt[:, ::-1, :].copy()
        gt = (gt - self.mean) / self.std
        return {"gt": gt, "gt_path": path}


@DATASET_REGISTRY.register()
class SingleImageDataset:
    def __init__(self, dataroot_lq: str, **_ignored: Any):
        lq_map = _scan(dataroot_lq)
        if not lq_map:
            raise ValueError(f"no images in {dataroot_lq}")
        self.paths = [lq_map[s] for s in sorted(lq_map)]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        path = self.paths[idx % len(self.paths)]
        return {"lq": _read_float01(path), "lq_path": path}
