"""Seeded inputs: preview and frame pools for serving, SID packs for
training, made on the device and written as a user's preparation writes
them.

An image is a smooth field (Gaussian noise at 1/32 of the size, upsampled
bilinearly, through a sigmoid) plus pixel noise. Content does not change
the work; size and bit depth do. A SID pair is a long exposure (the
field, read noise, 16 bits) and a short one (``long / ratio`` with shot
and read noise, 16 bits), stored in two SIDPacks of ``zlib_band``
records, the default of the port's ``create_sid_pack`` tool, with a
manifest beside them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.harness.weights import generator


@torch.no_grad()
def smooth_images(n: int, h: int, w: int, gen: torch.Generator, device,
                  noise: float) -> torch.Tensor:
    """``[n, 3, h, w]`` fp32 in [0, 1]."""
    lo = torch.randn((n, 3, max(h // 32, 2), max(w // 32, 2)),
                     generator=gen, device=device)
    x = torch.sigmoid(1.5 * F.interpolate(lo, size=(h, w), mode="bilinear",
                                          align_corners=False))
    x = x + noise * torch.randn((n, 3, h, w), generator=gen, device=device)
    return x.clamp_(0.0, 1.0)


def image_pool(n: int, h: int, w: int, seed: int, device) -> List[np.ndarray]:
    """``n`` float32 HWC images on the host, as a client sends them."""
    imgs = smooth_images(n, h, w, generator(seed, f"pool{h}x{w}", device),
                         device, noise=0.05)
    host = imgs.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return [host[i] for i in range(n)]


@torch.no_grad()
def sid_pairs(n: int, h: int, w: int, ratios: Sequence[float], seed: int,
              device) -> List[Tuple[np.ndarray, np.ndarray, float]]:
    """``(short, long, ratio)`` uint16 HWC pairs on the host."""
    gen = generator(seed, f"sid{h}x{w}", device)
    out = []
    for i in range(n):
        ratio = float(ratios[i % len(ratios)])
        long = smooth_images(1, h, w, gen, device, noise=0.002)[0] * 0.96 \
            + 0.02
        dark = long / ratio
        short = (dark + 0.08 * dark.sqrt() * torch.randn(
            dark.shape, generator=gen, device=device)
            + 0.002 * torch.randn(dark.shape, generator=gen, device=device))
        to16 = lambda t: (t.clamp(0.0, 1.0) * 65535.0).round().to(
            torch.int32).permute(1, 2, 0).contiguous().cpu().numpy().astype(
                np.uint16)
        out.append((to16(short), to16(long), ratio))
    return out


def sub_images(pairs, crop: int, step: int):
    """Each pair cut into ``crop``-sized sub-images at ``step``, the last
    row and column flush with the far edge (NAFNet's
    ``scripts/data_preparation/sidd.py``)."""
    out = []
    for short, long, ratio in pairs:
        h, w = long.shape[:2]
        ys = list(range(0, h - crop + 1, step))
        xs = list(range(0, w - crop + 1, step))
        ys += [h - crop] if ys[-1] != h - crop else []
        xs += [w - crop] if xs[-1] != w - crop else []
        for y in ys:
            for x in xs:
                out.append((np.ascontiguousarray(short[y:y + crop,
                                                       x:x + crop]),
                            np.ascontiguousarray(long[y:y + crop,
                                                      x:x + crop]), ratio))
    return out


def write_sid_root(root: str, pairs) -> Dict[str, str]:
    """Packs and manifest of the ``train`` subset; returns the paths the
    data set's options name."""
    from lowlight_image_enhancement_tpu_torch.data.records import (
        SidPackWriter,
    )

    os.makedirs(root, exist_ok=True)
    paths = {"manifest_path": os.path.join(root, "manifest_sid.json"),
             "short_path": os.path.join(root, "train_short.pack"),
             "long_path": os.path.join(root, "train_long.pack")}
    records = []
    with SidPackWriter(paths["short_path"], comp="zlib_band") as ws, \
            SidPackWriter(paths["long_path"], comp="zlib_band") as wl:
        for i, (short, long, ratio) in enumerate(pairs):
            key = f"train_{i:05d}"
            ws.add(key, short)
            wl.add(key, long)
            records.append({"pair_id": key, "subset": "train",
                            "short_key": key, "long_key": key,
                            "short_exposure": 0.1,
                            "long_exposure": 0.1 * ratio,
                            "exposure_ratio": ratio})
    with open(paths["manifest_path"], "w") as f:
        json.dump(records, f)
    return paths


class CropFinder:
    """Where a crop of a long exposure lies: each position of each long
    image keyed by its first four 16-bit values of channel 0."""

    def __init__(self, pairs):
        self.pairs = pairs
        self.keys = []
        for _, long, _ in pairs:
            v = long[:, :, 0].astype(np.uint64)
            self.keys.append((v[:, :-3] << np.uint64(48))
                             | (v[:, 1:-2] << np.uint64(32))
                             | (v[:, 2:-1] << np.uint64(16)) | v[:, 3:])

    def find(self, crop_u16: np.ndarray):
        """``(pair index, top, left)`` of an HWC uint16 crop, or None."""
        ph, pw = crop_u16.shape[:2]
        r = crop_u16[0, :4, 0].astype(np.uint64)
        key = (r[0] << np.uint64(48)) | (r[1] << np.uint64(32)) \
            | (r[2] << np.uint64(16)) | r[3]
        for i, keys in enumerate(self.keys):
            for top, left in zip(*np.nonzero(keys == key)):
                long = self.pairs[i][1]
                if np.array_equal(long[top:top + ph, left:left + pw],
                                  crop_u16):
                    return i, int(top), int(left)
        return None
