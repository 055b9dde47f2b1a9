"""Video frame-sequence datasets (stock BasicSR parity: REDS/Vimeo layout):
the port's copy of ``lowlight_image_enhancement_tpu/data/video_dataset.py``
(host code: numpy items, as the JAX data set gives them).

Rebuild of the reference's inherited video datasets
(``basicsr/data/reds_dataset.py:18`` / ``vimeo90k_dataset.py``, frame
padding per ``basicsr/data/data_util.py:41`` — unused by the
SID configs, kept for framework completeness): a clip is a folder of
numbered frames; items stack ``num_frame`` neighboring LQ frames around a
center index with frame-padding at clip edges, paired with the center GT
frame.

Layout::

    dataroot_gt/clipA/00000000.png ...
    dataroot_lq/clipA/00000000.png ...

Item: ``{"lq": [T, H, W, C] float32, "gt": [H, W, C], "key":
"clipA/00000003"}`` with train-phase joint random crops + flip/rot
augmentation applied consistently across the temporal stack.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from lowlight_image_enhancement_tpu_torch.data.paired_image_dataset import (
    _read_float01,
)
from lowlight_image_enhancement_tpu_torch.data.transforms import augment
from lowlight_image_enhancement_tpu_torch.utils.registry import DATASET_REGISTRY

_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def pad_frame_indices(center: int, num_frames_clip: int, num_frame: int,
                      mode: str = "reflection") -> List[int]:
    """Neighboring indices around ``center`` with edge padding
    (reference ``generate_frame_indices``): ``replicate`` clamps,
    ``reflection`` mirrors."""
    half = num_frame // 2
    out = []
    for offset in range(-half, half + 1):
        idx = center + offset
        if mode == "replicate":
            idx = min(max(idx, 0), num_frames_clip - 1)
        elif mode == "reflection":
            if idx < 0:
                idx = -idx
            elif idx >= num_frames_clip:
                idx = 2 * (num_frames_clip - 1) - idx
            idx = min(max(idx, 0), num_frames_clip - 1)
        else:
            raise ValueError(f"unknown padding mode {mode!r}")
        out.append(idx)
    return out


@DATASET_REGISTRY.register()
class VideoFrameDataset:
    """Paired multi-frame restoration dataset (REDS/Vimeo-style)."""

    def __init__(
        self,
        dataroot_gt: str,
        dataroot_lq: str,
        num_frame: int = 5,
        phase: str = "train",
        gt_size: Optional[int] = None,
        frame_padding: str = "reflection",
        use_flip: bool = True,
        use_rot: bool = True,
        seed: int = 0,
        **_ignored: Any,
    ):
        if num_frame % 2 != 1:
            raise ValueError("num_frame must be odd")
        self.num_frame = num_frame
        self.phase = phase
        self.gt_size = gt_size
        self.frame_padding = frame_padding
        self.use_flip = use_flip
        self.use_rot = use_rot
        self._rng = np.random.default_rng(seed)

        self.clips: List[Tuple[str, List[str], List[str]]] = []
        self.items: List[Tuple[int, int]] = []  # (clip_idx, center_frame)
        for clip in sorted(os.listdir(dataroot_gt)):
            gt_dir = os.path.join(dataroot_gt, clip)
            lq_dir = os.path.join(dataroot_lq, clip)
            if not (os.path.isdir(gt_dir) and os.path.isdir(lq_dir)):
                continue
            gt_frames = sorted(
                os.path.join(gt_dir, f) for f in os.listdir(gt_dir)
                if f.lower().endswith(_EXTS)
            )
            lq_frames = sorted(
                os.path.join(lq_dir, f) for f in os.listdir(lq_dir)
                if f.lower().endswith(_EXTS)
            )
            if len(gt_frames) != len(lq_frames) or not gt_frames:
                continue
            ci = len(self.clips)
            self.clips.append((clip, lq_frames, gt_frames))
            self.items.extend((ci, fi) for fi in range(len(gt_frames)))
        if not self.items:
            raise ValueError(
                f"no paired clips under {dataroot_gt} / {dataroot_lq}"
            )

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        ci, center = self.items[idx % len(self.items)]
        clip, lq_frames, gt_frames = self.clips[ci]
        indices = pad_frame_indices(center, len(lq_frames), self.num_frame,
                                    self.frame_padding)
        lqs = [_read_float01(lq_frames[i]) for i in indices]
        gt = _read_float01(gt_frames[center])

        if self.phase == "train" and self.gt_size:
            h, w = lqs[0].shape[:2]
            ps = self.gt_size
            top = int(self._rng.integers(0, max(h - ps, 0) + 1))
            left = int(self._rng.integers(0, max(w - ps, 0) + 1))
            lqs = [im[top:top + ps, left:left + ps] for im in lqs]
            gt = gt[top:top + ps, left:left + ps]
            stacked = augment(lqs + [gt], hflip=self.use_flip,
                              rotation=self.use_rot, rng=self._rng)
            lqs, gt = stacked[:-1], stacked[-1]

        name = os.path.splitext(os.path.basename(gt_frames[center]))[0]
        return {
            "lq": np.stack(lqs),
            "gt": gt,
            "key": f"{clip}/{name}",
        }
