"""Inference serving: shape bucketing + batched forward on the card.

Counterpart of ``lowlight_image_enhancement_tpu/serving.py``:

- **Shape bucketing**: an H x W input is zero-padded up to the bucket grid
  (multiples of ``bucket_step``, at least ``min_bucket``). The padding is
  kept exactly as in the JAX server: the SCA mean of every NAFBlock is
  taken over the padded image, so the bucket changes the result.
- **Batching**: requests sharing a bucket run as one batch of at most
  ``max_batch``. Unlike the JAX server, the batch is not padded up to
  ``max_batch``: eager PyTorch needs no static shapes, and no op mixes
  images of a batch, so each image's result is identical either way.
- **Tiling**: inputs larger than ``max_bucket`` go through overlapping
  tiled inference (:func:`...training.validation.tiled_inference`), with
  its ``batch_tiles`` padding kept.

Example::

    server = RestorationServer(net)             # net: an nn.Module, NCHW
    outs = server.predict([img_hwc_1, ...])     # float [0,1] HWC numpy
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device


def _bucket_dim(size: int, step: int, min_size: int) -> int:
    """Round up to the bucket grid (multiples of ``step``, >= min_size)."""
    b = max(size, min_size)
    return ((b + step - 1) // step) * step


class RestorationServer:
    """Batched, bucketed restoration inference of an NCHW model."""

    def __init__(
        self,
        net: torch.nn.Module,
        bucket_step: int = 64,
        min_bucket: int = 64,
        max_bucket: int = 1024,
        max_batch: int = 8,
        tile_overlap: float = 0.5,
        device: Any = "cuda",
    ):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.bucket_step = bucket_step
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.max_batch = max_batch
        self.tile_overlap = tile_overlap
        self.forward_batches = 0   # model forwards run so far

    def _forward(self, batch_nhwc: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(batch_nhwc, np.float32))
        x = x.to(self.device).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            y = self.net(x)
        self.forward_batches += 1
        return y.permute(0, 2, 3, 1).float().cpu().numpy()

    def _predict_bucket(self, imgs: List[np.ndarray], indices: List[int],
                        out: List[Optional[np.ndarray]]) -> None:
        bh = _bucket_dim(max(im.shape[0] for im in imgs),
                         self.bucket_step, self.min_bucket)
        bw = _bucket_dim(max(im.shape[1] for im in imgs),
                         self.bucket_step, self.min_bucket)
        for start in range(0, len(imgs), self.max_batch):
            chunk = imgs[start : start + self.max_batch]
            batch = np.zeros((len(chunk), bh, bw, 3), np.float32)
            for i, im in enumerate(chunk):
                batch[i, : im.shape[0], : im.shape[1], :] = im
            y = self._forward(batch)
            for i, idx in enumerate(indices[start : start + self.max_batch]):
                im = chunk[i]
                out[idx] = y[i, : im.shape[0], : im.shape[1], :]

    def _predict_tiled(self, img: np.ndarray) -> np.ndarray:
        from lowlight_image_enhancement_tpu_torch.training.validation import (
            tiled_inference,
        )

        out = tiled_inference(self._forward, img[None], self.max_bucket,
                              self.tile_overlap, batch_tiles=8)
        return out[0]

    def predict(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Restore a list of float [0,1] HWC images (any sizes).

        Returns outputs at the original sizes, in input order.
        """
        out: List[Optional[np.ndarray]] = [None] * len(images)
        buckets: Dict[Tuple[int, int], Tuple[List[np.ndarray], List[int]]] = \
            defaultdict(lambda: ([], []))
        for idx, img in enumerate(images):
            img = np.asarray(img, np.float32)
            if img.ndim != 3 or img.shape[-1] != 3:
                raise ValueError(f"expected HWC RGB image, got {img.shape}")
            h, w = img.shape[:2]
            if max(h, w) > self.max_bucket:
                out[idx] = self._predict_tiled(img)
                continue
            key = (_bucket_dim(h, self.bucket_step, self.min_bucket),
                   _bucket_dim(w, self.bucket_step, self.min_bucket))
            buckets[key][0].append(img)
            buckets[key][1].append(idx)
        for imgs, indices in buckets.values():
            self._predict_bucket(imgs, indices, out)
        return out  # type: ignore[return-value]
