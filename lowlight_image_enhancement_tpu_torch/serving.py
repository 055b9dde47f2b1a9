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
- **Spans**: each call is a ``serving.predict`` span (its unit the call
  number, ``calls``) over ``serving.pad``, ``serving.h2d``,
  ``serving.forward``, ``serving.wait``, ``serving.d2h`` and
  ``serving.gather`` (and the tiled path's ``validation.*`` spans);
  ``serving.px_in`` counts the input pixels of a call, ``serving.px_run``
  those of every batch run, padding and tile overlap included
  (``utils/profiling.py``: recorded only under a profiler).
- **Mesh**: with ``mesh`` (an in-process mesh of local devices,
  ``parallel.create_mesh(devices=[...])``) every device holds a replica
  of the network, each forward batch is split along dim 0 across them
  and the results are gathered in order; no collective is needed. The
  tiled path rounds ``batch_tiles`` up to a multiple of the mesh size.

Example::

    server = RestorationServer(net)             # net: an nn.Module, NCHW
    outs = server.predict([img_hwc_1, ...])     # float [0,1] HWC numpy
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.utils.profiling import (
    count,
    recording,
    span,
)


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
        mesh=None,
    ):
        if mesh is not None and mesh.distributed:
            raise ValueError("RestorationServer takes an in-process mesh of "
                             "local devices (create_mesh(devices=[...]))")
        self.mesh = mesh
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))
        self.net = net.to(self.device).eval()
        # (device, replica) per mesh device; the first replica is the net
        self.replicas = [(self.device, self.net)] + [
            (dev, copy.deepcopy(self.net).to(dev).eval())
            for dev in (mesh.devices[1:] if mesh is not None else ())]
        self.bucket_step = bucket_step
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.max_batch = max_batch
        self.tile_overlap = tile_overlap
        self.forward_batches = 0   # model forwards run so far
        self.calls = 0             # predict calls so far

    def _forward(self, batch_nhwc: np.ndarray) -> np.ndarray:
        """One forward batch, split along dim 0 over the replicas (all
        enqueued before any result is read back): a ``serving.h2d`` and a
        ``serving.forward`` span per replica. While recording, the readback
        waits for the forward first (``serving.wait``), so that
        ``serving.d2h`` times the copies alone."""
        n, h, w = batch_nhwc.shape[:3]
        count("serving.px_run", n * h * w)
        x = torch.from_numpy(np.ascontiguousarray(batch_nhwc, np.float32))
        parts = [p for p in torch.tensor_split(x, len(self.replicas))
                 if p.shape[0]]
        ys = []
        with torch.inference_mode():
            for (dev, net), part in zip(self.replicas, parts):
                with span("serving.h2d"):
                    xd = part.to(dev).permute(0, 3, 1, 2).contiguous()
                with span("serving.forward"):
                    ys.append(net(xd))
        self.forward_batches += 1
        if recording():
            with span("serving.wait"):
                for dev, _ in self.replicas:
                    if dev.type == "cuda":
                        torch.cuda.current_stream(dev).synchronize()
        with span("serving.d2h"):
            hs = [y.permute(0, 2, 3, 1).float().cpu().numpy() for y in ys]
        with span("serving.gather"):
            return np.concatenate(hs)

    def _predict_bucket(self, imgs: List[np.ndarray], indices: List[int],
                        out: List[Optional[np.ndarray]]) -> None:
        bh = _bucket_dim(max(im.shape[0] for im in imgs),
                         self.bucket_step, self.min_bucket)
        bw = _bucket_dim(max(im.shape[1] for im in imgs),
                         self.bucket_step, self.min_bucket)
        for start in range(0, len(imgs), self.max_batch):
            chunk = imgs[start : start + self.max_batch]
            with span("serving.pad"):
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

        nd = len(self.replicas)
        bt = -(-max(8, nd) // nd) * nd
        out = tiled_inference(self._forward, img[None], self.max_bucket,
                              self.tile_overlap, batch_tiles=bt)
        return out[0]

    def predict(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Restore a list of float [0,1] HWC images (any sizes).

        Returns outputs at the original sizes, in input order.
        """
        self.calls += 1
        with span("serving.predict", unit=self.calls):
            out: List[Optional[np.ndarray]] = [None] * len(images)
            buckets: Dict[Tuple[int, int],
                          Tuple[List[np.ndarray], List[int]]] = \
                defaultdict(lambda: ([], []))
            for idx, img in enumerate(images):
                img = np.asarray(img, np.float32)
                if img.ndim != 3 or img.shape[-1] != 3:
                    raise ValueError(
                        f"expected HWC RGB image, got {img.shape}")
                h, w = img.shape[:2]
                count("serving.px_in", h * w)
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
