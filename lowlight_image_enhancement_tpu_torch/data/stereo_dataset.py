"""Stereo SR training datasets (the NAFSSR data path).

Counterpart of ``lowlight_image_enhancement_tpu/data/stereo_dataset.py``
(reference ``basicsr/data/paired_image_SR_LR_dataset.py:19-300`` and
``paired_image_SR_LR_FullImage_Memory_dataset.py``), with the same numpy
draws in the same order, so a seed gives the JAX package's items bit for
bit. Each item is a left/right view pair concatenated on the channel axis
into a 6-channel HWC float32 [0, 1] array, the input of
:class:`...models.nafssr.NAFSSR` once the loader's prefetcher has moved it
to the card as NCHW.

- :class:`PairedImageSRLRDataset` -- flat folders of ``{i:04d}_L.png`` /
  ``{i:04d}_R.png`` under ``dataroot_gt`` / ``dataroot_lq``; train phase:
  reflect-pad to ``gt_size``, square ``paired_random_crop``, flip / rot.
- :class:`PairedStereoImageDataset` -- one directory per sample holding
  ``hr0/hr1.png`` (gt) and ``lr0/lr1.png`` (lq), the Flickr1024 / KITTI /
  Middlebury layout; train phase: the optional ``flip_RGB`` channel
  permutation (the same on both views), a rectangular
  ``paired_random_crop_hw``, hflip / vflip / rot.
- :class:`PairedImageSRLRFullImageMemoryDataset` -- whole data sets in
  memory as sequences of uint8 HWC 6-channel arrays (pickle, ``.npz`` or
  ``.npy``), the index modulo the set size.

Views are RGB end to end (the port's :mod:`..utils.imgio` decodes RGB).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Sequence

import numpy as np

from lowlight_image_enhancement_tpu_torch.data.paired_image_dataset import (
    _read_float01,
)
from lowlight_image_enhancement_tpu_torch.data.transforms import (
    augment,
    pad_to_min_size,
    paired_random_crop,
    paired_random_crop_hw,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import DATASET_REGISTRY

# The 6 channel-permutations of (R,G,B) applied jointly to both stereo
# views (reference ``paired_image_SR_LR_dataset.py:256-266 flip_RGB``).
_RGB_PERMS = (
    (0, 1, 2, 3, 4, 5),
    (0, 2, 1, 3, 5, 4),
    (1, 0, 2, 4, 3, 5),
    (1, 2, 0, 4, 5, 3),
    (2, 0, 1, 5, 3, 4),
    (2, 1, 0, 5, 4, 3),
)


def _read_lr_pair(folder: str, left: str, right: str) -> np.ndarray:
    l_img = _read_float01(os.path.join(folder, left))
    r_img = _read_float01(os.path.join(folder, right))
    if l_img.shape != r_img.shape:
        raise ValueError(
            f"stereo views differ in shape: {left} {l_img.shape} vs "
            f"{right} {r_img.shape}")
    return np.concatenate([l_img, r_img], axis=-1)


@DATASET_REGISTRY.register()
class PairedImageSRLRDataset:
    """Indexed ``_L``/``_R`` stereo pairs in flat gt/lq folders
    (reference ``paired_image_SR_LR_dataset.py:19-181``)."""

    def __init__(
        self,
        dataroot_gt: str,
        dataroot_lq: str,
        phase: str = "train",
        gt_size: Optional[int] = None,
        scale: int = 1,
        use_flip: bool = True,
        use_rot: bool = True,
        seed: int = 0,
        **_ignored: Any,
    ):
        nums_lq = len(os.listdir(dataroot_lq))
        nums_gt = len(os.listdir(dataroot_gt))
        if nums_lq != nums_gt:
            raise ValueError(
                f"gt/lq counts differ: {nums_gt} vs {nums_lq}")
        self.gt_folder, self.lq_folder = dataroot_gt, dataroot_lq
        self.nums = nums_lq
        self.phase = phase
        self.gt_size = gt_size
        self.scale = scale
        self.use_flip = use_flip
        self.use_rot = use_rot
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        # two files (L, R) per sample — reference ``:180-181``
        return self.nums // 2

    def __getitem__(self, index: int) -> Dict[str, Any]:
        index = index % len(self)
        name = f"{index + 1:04}"
        gt = _read_lr_pair(self.gt_folder, f"{name}_L.png", f"{name}_R.png")
        lq = _read_lr_pair(self.lq_folder, f"{name}_L.png", f"{name}_R.png")
        if self.phase == "train" and self.gt_size:
            lq, gt = pad_to_min_size(lq, gt, self.gt_size, self.scale)
            gt, lq = paired_random_crop(
                gt, lq, self.gt_size // self.scale, self.scale,
                rng=self._rng)
            gt, lq = augment([gt, lq], hflip=self.use_flip,
                             rotation=self.use_rot, rng=self._rng)
        return {"lq": lq, "gt": gt, "lq_path": name, "gt_path": name}


@DATASET_REGISTRY.register()
class PairedStereoImageDataset:
    """Directory-per-sample stereo SR dataset — Flickr1024/KITTI/
    Middlebury layout (reference ``paired_image_SR_LR_dataset.py:184-300``):
    ``<dataroot_gt>/<sample>/hr0.png``+``hr1.png`` and
    ``<dataroot_lq>/<sample>/lr0.png``+``lr1.png``."""

    def __init__(
        self,
        dataroot_gt: str,
        dataroot_lq: str,
        phase: str = "train",
        gt_size: Optional[int] = None,
        gt_size_h: Optional[int] = None,
        gt_size_w: Optional[int] = None,
        scale: int = 1,
        use_hflip: bool = True,
        use_vflip: bool = False,
        use_rot: bool = False,
        flip_RGB: bool = False,
        seed: int = 0,
        **_ignored: Any,
    ):
        self.gt_folder, self.lq_folder = dataroot_gt, dataroot_lq
        self.gt_files = sorted(os.listdir(dataroot_gt))
        self.lq_files = sorted(os.listdir(dataroot_lq))
        if len(self.gt_files) != len(self.lq_files):
            raise ValueError(
                f"gt/lq sample counts differ: {len(self.gt_files)} vs "
                f"{len(self.lq_files)}")
        self.phase = phase
        self.gt_size = gt_size
        self.gt_size_h = gt_size_h
        self.gt_size_w = gt_size_w
        self.scale = scale
        self.use_hflip = use_hflip
        self.use_vflip = use_vflip
        self.use_rot = use_rot
        self.flip_RGB = flip_RGB
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.gt_files)

    def _patch_hw(self):
        if self.gt_size_h is not None and self.gt_size_w is not None:
            return int(self.gt_size_h), int(self.gt_size_w)
        return int(self.gt_size), int(self.gt_size)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        index = index % len(self)
        gt_dir = os.path.join(self.gt_folder, self.gt_files[index])
        lq_dir = os.path.join(self.lq_folder, self.lq_files[index])
        gt = _read_lr_pair(gt_dir, "hr0.png", "hr1.png")
        lq = _read_lr_pair(lq_dir, "lr0.png", "lr1.png")
        if self.phase == "train":
            if self.flip_RGB:
                perm = _RGB_PERMS[int(self._rng.random() * 6)]
                gt = gt[:, :, perm]
                lq = lq[:, :, perm]
            ph, pw = self._patch_hw()
            gt, lq = paired_random_crop_hw(gt, lq, ph, pw, self.scale,
                                           rng=self._rng)
            (gt, lq), _status = augment(
                [gt, lq], hflip=self.use_hflip, rotation=self.use_rot,
                vflip=self.use_vflip, rng=self._rng, return_status=True)
        return {"lq": lq, "gt": gt, "lq_path": lq_dir, "gt_path": gt_dir}


def _load_memory_blob(path: str) -> Sequence[np.ndarray]:
    """A sequence of HWC uint8 arrays from a pickle (reference contract:
    ``pickle.load`` of a list, ``paired_image_SR_LR_FullImage_Memory_
    dataset.py:74-80``), ``.npz`` (sorted keys) or ``.npy`` stack."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path) as z:
            return [z[k] for k in sorted(z.files)]
    if ext == ".npy":
        return list(np.load(path))
    with open(path, "rb") as f:
        return pickle.load(f)


@DATASET_REGISTRY.register()
class PairedImageSRLRFullImageMemoryDataset:
    """Whole-dataset-in-memory stereo pairs: ``dataroot_gt``/
    ``dataroot_lq`` are single files holding sequences of uint8 HWC
    6-channel full images; samples index modulo the set size and are
    cropped per draw (reference
    ``paired_image_SR_LR_FullImage_Memory_dataset.py``). Lazy-loaded on
    first access, like the reference's first-``__getitem__`` unpickle."""

    def __init__(
        self,
        dataroot_gt: str,
        dataroot_lq: str,
        phase: str = "train",
        gt_size: Optional[int] = None,
        gt_size_h: Optional[int] = None,
        gt_size_w: Optional[int] = None,
        scale: int = 1,
        use_flip: bool = True,
        use_rot: bool = True,
        num_samples: Optional[int] = None,
        seed: int = 0,
        **_ignored: Any,
    ):
        self.dataroot_gt = dataroot_gt
        self.dataroot_lq = dataroot_lq
        self.gts: Optional[Sequence[np.ndarray]] = None
        self.lqs: Optional[Sequence[np.ndarray]] = None
        self.phase = phase
        self.gt_size = gt_size
        self.gt_size_h = gt_size_h
        self.gt_size_w = gt_size_w
        self.scale = scale
        self.use_flip = use_flip
        self.use_rot = use_rot
        # the reference exposes a virtual length through the sampler's
        # enlarge ratio; num_samples pins __len__ for our Loader
        self.num_samples = num_samples
        self._rng = np.random.default_rng(seed)

    def _ensure_loaded(self) -> None:
        if self.lqs is None:
            self.lqs = _load_memory_blob(self.dataroot_lq)
        if self.gts is None:
            self.gts = _load_memory_blob(self.dataroot_gt)
            if len(self.gts) != len(self.lqs):
                raise ValueError(
                    f"gt/lq lengths differ: {len(self.gts)} vs "
                    f"{len(self.lqs)}")

    def __len__(self) -> int:
        if self.num_samples is not None:
            return self.num_samples
        self._ensure_loaded()
        return len(self.lqs)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        self._ensure_loaded()
        index = index % len(self.lqs)
        lq = self.lqs[index].astype(np.float32) / 255.0
        gt = self.gts[index].astype(np.float32) / 255.0
        if self.phase == "train":
            ph = int(self.gt_size_h or self.gt_size)
            pw = int(self.gt_size_w or self.gt_size)
            gt, lq = paired_random_crop_hw(gt, lq, ph, pw, self.scale,
                                           rng=self._rng)
            gt, lq = augment([gt, lq], hflip=self.use_flip,
                             rotation=self.use_rot, rng=self._rng)
        return {"lq": np.ascontiguousarray(lq),
                "gt": np.ascontiguousarray(gt),
                "lq_path": str(index), "gt_path": str(index)}
