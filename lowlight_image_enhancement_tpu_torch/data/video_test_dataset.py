"""Video *test* datasets: per-clip folder enumeration with borders/cache.

Rebuild of the reference's test-time video datasets
(``basicsr/data/video_test_dataset.py:17-331``) and their data_util
helpers (``basicsr/data/data_util.py:17-39`` ``read_img_seq``,
``:41-95`` ``generate_frame_indices``, ``:290-341``
``generate_gaussian_kernel``/``duf_downsample``).

Counterpart of ``lowlight_image_enhancement_tpu/data/video_test_dataset.py``,
with its conventions (deliberate deltas from the torch original):

* items are float32 **NHWC** numpy ([T, H, W, C] clips), not CHW torch
  tensors;
* image decode goes through the port's codec (``utils/imgio``) — RGB end
  to end, no BGR stage;
* :func:`duf_downsample` is reflect padding plus a strided ``F.conv2d``
  on the device of its input, in the input's precision (no TF32).

The training-side ``VideoFrameDataset`` (``data/video_dataset.py``) keeps
its simpler ``pad_frame_indices`` (2-mode) for REDS/Vimeo training clips;
this module carries the full 4-mode test-protocol index generator.
"""

from __future__ import annotations

import functools
import glob
from os import path as osp
from typing import Any, Dict, List, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from lowlight_image_enhancement_tpu_torch.data.paired_image_dataset import (
    _read_float01,
)
from lowlight_image_enhancement_tpu_torch.data.transforms import mod_crop
from lowlight_image_enhancement_tpu_torch.utils.misc import scandir
from lowlight_image_enhancement_tpu_torch.utils.registry import DATASET_REGISTRY


def read_img_seq(path: Union[str, Sequence[str]],
                 require_mod_crop: bool = False,
                 scale: int = 1) -> np.ndarray:
    """Read an image sequence as ``[T, H, W, C]`` float32 RGB in [0,1].

    Reference ``data_util.py:17-39`` (which returns a CHW torch stack);
    ``path`` is a list of files or a folder to enumerate sorted.
    """
    if isinstance(path, (list, tuple)):
        img_paths = list(path)
    else:
        img_paths = sorted(scandir(path, full_path=True))
    imgs = [_read_float01(p) for p in img_paths]
    if require_mod_crop:
        imgs = [mod_crop(img, scale) for img in imgs]
    return np.stack(imgs, axis=0)


def generate_frame_indices(crt_idx: int, max_frame_num: int,
                           num_frames: int,
                           padding: str = "reflection") -> List[int]:
    """Center-window frame indices with edge padding — exact reference
    contract (``data_util.py:41-95``), e.g. for ``crt_idx=0,
    num_frames=5``: replicate ``[0,0,0,1,2]``, reflection ``[2,1,0,1,2]``,
    reflection_circle ``[4,3,0,1,2]``, circle ``[3,4,0,1,2]``."""
    assert num_frames % 2 == 1, "num_frames should be an odd number."
    assert padding in ("replicate", "reflection", "reflection_circle",
                       "circle"), f"Wrong padding mode: {padding}."
    max_frame_num = max_frame_num - 1  # 0-based last index
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            if padding == "replicate":
                pad_idx = 0
            elif padding == "reflection":
                pad_idx = -i
            elif padding == "reflection_circle":
                pad_idx = crt_idx + num_pad - i
            else:
                pad_idx = num_frames + i
        elif i > max_frame_num:
            if padding == "replicate":
                pad_idx = max_frame_num
            elif padding == "reflection":
                pad_idx = max_frame_num * 2 - i
            elif padding == "reflection_circle":
                pad_idx = (crt_idx - num_pad) - (i - max_frame_num)
            else:
                pad_idx = i - num_frames
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def generate_gaussian_kernel(kernel_size: int = 13,
                             sigma: float = 1.6) -> np.ndarray:
    """Gaussian kernel for ``duf_downsample`` (``data_util.py:290-306``):
    a dirac delta smoothed by a Gaussian filter."""
    from scipy.ndimage import gaussian_filter

    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return gaussian_filter(kernel, sigma)


@functools.lru_cache(maxsize=None)
def _duf_kernel(kernel_size: int, scale: int) -> np.ndarray:
    """The DUF Gaussian of ``(kernel_size, scale)`` (read-only)."""
    kernel = generate_gaussian_kernel(kernel_size, 0.4 * scale)
    kernel.setflags(write=False)
    return kernel


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each of ``n + 2 pad`` positions of an axis of size
    ``n`` padded by ``pad`` under numpy's ``reflect`` mode, which repeats
    the reflection where ``pad >= n`` (``F.pad`` raises there)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def duf_downsample(x, kernel_size: int = 13, scale: int = 4) -> torch.Tensor:
    """DUF-official Gaussian downsampling (``data_util.py:309-341``).

    Args:
      x: ``[B, T, H, W, C]`` or ``[T, H, W, C]`` float array (numpy or a
        tensor; NHWC — the reference takes BTCHW torch tensors).
      kernel_size / scale: DUF protocol params; scale in (2, 3, 4).

    Returns the downsampled frames as a tensor on ``x``'s device (the CPU
    for numpy), same leading dims.
    """
    assert scale in (2, 3, 4), \
        f"Only support scale (2, 3, 4), but got {scale}."
    x = torch.as_tensor(x)
    squeeze = x.dim() == 4
    if squeeze:
        x = x[None]
    b, t, h, w, c = x.shape
    pad = kernel_size // 2 + scale * 2
    planes = x.permute(0, 1, 4, 2, 3).reshape(-1, 1, h, w)
    planes = planes.index_select(2, _reflect_index(h, pad, x.device))
    planes = planes.index_select(3, _reflect_index(w, pad, x.device))
    weight = torch.tensor(_duf_kernel(kernel_size, scale), dtype=x.dtype,
                             device=x.device)[None, None]
    with torch.backends.cudnn.flags(allow_tf32=False):
        y = F.conv2d(planes, weight, stride=scale)[:, :, 2:-2, 2:-2]
    y = y.reshape(b, t, c, y.shape[2], y.shape[3]).permute(0, 1, 3, 4, 2)
    return y[0] if squeeze else y


@DATASET_REGISTRY.register()
class VideoTestDataset:
    """Per-clip video test dataset (Vid4 / REDS4 / REDSofficial layouts).

    Reference contract (``video_test_dataset.py:17-153``): enumerates
    ``dataroot_{lq,gt}/<subfolder>/<frames>`` (optionally restricted by a
    ``meta_info_file``), records per-frame ``folder``, ``idx`` (``"i/N"``)
    and ``border`` flags (1 inside ``num_frame//2`` of a clip edge), and
    either caches whole decoded clips (``cache_data``) or re-reads the
    frame window per item.  Items are NHWC: ``lq [T,H,W,C]``,
    ``gt [H,W,C]``.
    """

    SUPPORTED = ("vid4", "reds4", "redsofficial")

    def __init__(self, opt: Dict[str, Any]):
        self.opt = dict(opt)
        self.cache_data = bool(opt["cache_data"])
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.data_info: Dict[str, list] = {
            "lq_path": [], "gt_path": [], "folder": [], "idx": [],
            "border": []}
        io_backend = opt.get("io_backend", {"type": "disk"})
        assert io_backend.get("type") != "lmdb", \
            "No need to use lmdb during validation/test."

        if "meta_info_file" in opt and opt["meta_info_file"]:
            with open(opt["meta_info_file"]) as fin:
                subfolders = [line.split(" ")[0].strip() for line in fin
                              if line.strip()]
            subfolders_lq = [osp.join(self.lq_root, k) for k in subfolders]
            subfolders_gt = [osp.join(self.gt_root, k) for k in subfolders]
        else:
            subfolders_lq = sorted(glob.glob(osp.join(self.lq_root, "*")))
            subfolders_gt = sorted(glob.glob(osp.join(self.gt_root, "*")))

        if opt["name"].lower() not in self.SUPPORTED:
            raise ValueError(
                f"Non-supported video test dataset: {opt['name']}")

        self.imgs_lq: Dict[str, Any] = {}
        self.imgs_gt: Dict[str, Any] = {}
        for sub_lq, sub_gt in zip(subfolders_lq, subfolders_gt):
            name = osp.basename(sub_lq)
            paths_lq = sorted(scandir(sub_lq, full_path=True))
            paths_gt = sorted(scandir(sub_gt, full_path=True))
            max_idx = len(paths_lq)
            assert max_idx == len(paths_gt), (
                f"Different number of images in lq ({max_idx}) and gt "
                f"folders ({len(paths_gt)})")
            self.data_info["lq_path"].extend(paths_lq)
            self.data_info["gt_path"].extend(paths_gt)
            self.data_info["folder"].extend([name] * max_idx)
            self.data_info["idx"].extend(
                f"{i}/{max_idx}" for i in range(max_idx))
            border = [0] * max_idx
            for i in range(self.opt["num_frame"] // 2):
                border[i] = 1
                border[max_idx - i - 1] = 1
            self.data_info["border"].extend(border)

            if self.cache_data:
                self.imgs_lq[name] = read_img_seq(paths_lq)
                self.imgs_gt[name] = read_img_seq(paths_gt)
            else:
                self.imgs_lq[name] = paths_lq
                self.imgs_gt[name] = paths_gt

    def __getitem__(self, index: int) -> Dict[str, Any]:
        folder = self.data_info["folder"][index]
        idx, max_idx = map(int, self.data_info["idx"][index].split("/"))
        border = self.data_info["border"][index]
        lq_path = self.data_info["lq_path"][index]

        select_idx = generate_frame_indices(
            idx, max_idx, self.opt["num_frame"],
            padding=self.opt.get("padding", "reflection"))

        if self.cache_data:
            imgs_lq = self.imgs_lq[folder][select_idx]
            img_gt = self.imgs_gt[folder][idx]
        else:
            imgs_lq = read_img_seq(
                [self.imgs_lq[folder][i] for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]])[0]

        return {"lq": imgs_lq, "gt": img_gt, "folder": folder,
                "idx": self.data_info["idx"][index], "border": border,
                "lq_path": lq_path}

    def __len__(self) -> int:
        return len(self.data_info["gt_path"])


@DATASET_REGISTRY.register()
class VideoTestVimeo90KDataset:
    """Vimeo90K-Test: one center GT (``im4``) per 7-frame septuplet
    (reference ``video_test_dataset.py:156-234``)."""

    def __init__(self, opt: Dict[str, Any]):
        self.opt = dict(opt)
        self.cache_data = bool(opt["cache_data"])
        if self.cache_data:
            raise NotImplementedError(
                "cache_data in Vimeo90K-Test dataset is not implemented.")
        self.gt_root, self.lq_root = opt["dataroot_gt"], opt["dataroot_lq"]
        self.data_info: Dict[str, list] = {
            "lq_path": [], "gt_path": [], "folder": [], "idx": [],
            "border": []}
        neighbor_list = [i + (9 - opt["num_frame"]) // 2
                         for i in range(opt["num_frame"])]
        io_backend = opt.get("io_backend", {"type": "disk"})
        assert io_backend.get("type") != "lmdb", \
            "No need to use lmdb during validation/test."

        with open(opt["meta_info_file"]) as fin:
            subfolders = [line.split(" ")[0].strip() for line in fin
                          if line.strip()]
        for idx, subfolder in enumerate(subfolders):
            self.data_info["gt_path"].append(
                osp.join(self.gt_root, subfolder, "im4.png"))
            self.data_info["lq_path"].append(
                [osp.join(self.lq_root, subfolder, f"im{i}.png")
                 for i in neighbor_list])
            self.data_info["folder"].append("vimeo90k")
            self.data_info["idx"].append(f"{idx}/{len(subfolders)}")
            self.data_info["border"].append(0)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        lq_path = self.data_info["lq_path"][index]
        imgs_lq = read_img_seq(lq_path)
        img_gt = read_img_seq([self.data_info["gt_path"][index]])[0]
        return {"lq": imgs_lq, "gt": img_gt,
                "folder": self.data_info["folder"][index],
                "idx": self.data_info["idx"][index],
                "border": self.data_info["border"][index],
                "lq_path": lq_path[self.opt["num_frame"] // 2]}

    def __len__(self) -> int:
        return len(self.data_info["gt_path"])


@DATASET_REGISTRY.register()
class VideoTestDUFDataset(VideoTestDataset):
    """DUF test protocol: optionally synthesize LQ frames by Gaussian
    downsampling the GT clip (reference ``video_test_dataset.py:237-296``).

    Extra opt keys: ``use_duf_downsampling`` (bool), ``scale`` (int).
    """

    def __getitem__(self, index: int) -> Dict[str, Any]:
        folder = self.data_info["folder"][index]
        idx, max_idx = map(int, self.data_info["idx"][index].split("/"))
        border = self.data_info["border"][index]
        lq_path = self.data_info["lq_path"][index]

        select_idx = generate_frame_indices(
            idx, max_idx, self.opt["num_frame"],
            padding=self.opt.get("padding", "reflection"))

        if self.cache_data:
            if self.opt["use_duf_downsampling"]:
                imgs_lq = self.imgs_gt[folder][select_idx]
                imgs_lq = duf_downsample(
                    imgs_lq, kernel_size=13, scale=self.opt["scale"]).numpy()
            else:
                imgs_lq = self.imgs_lq[folder][select_idx]
            img_gt = self.imgs_gt[folder][idx]
        else:
            if self.opt["use_duf_downsampling"]:
                imgs_lq = read_img_seq(
                    [self.imgs_gt[folder][i] for i in select_idx],
                    require_mod_crop=True, scale=self.opt["scale"])
                imgs_lq = duf_downsample(
                    imgs_lq, kernel_size=13, scale=self.opt["scale"]).numpy()
            else:
                imgs_lq = read_img_seq(
                    [self.imgs_lq[folder][i] for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]],
                                  require_mod_crop=True,
                                  scale=self.opt["scale"])[0]

        return {"lq": imgs_lq, "gt": img_gt, "folder": folder,
                "idx": self.data_info["idx"][index], "border": border,
                "lq_path": lq_path}


@DATASET_REGISTRY.register()
class VideoRecurrentTestDataset(VideoTestDataset):
    """Whole-clip items for recurrent models (reference
    ``video_test_dataset.py:299-331``); requires ``cache_data``."""

    def __init__(self, opt: Dict[str, Any]):
        super().__init__(opt)
        self.folders = sorted(set(self.data_info["folder"]))

    def __getitem__(self, index: int) -> Dict[str, Any]:
        folder = self.folders[index]
        if not self.cache_data:
            raise NotImplementedError(
                "Without cache_data is not implemented.")
        return {"lq": self.imgs_lq[folder], "gt": self.imgs_gt[folder],
                "folder": folder}

    def __len__(self) -> int:
        return len(self.folders)
