"""Validation: tiled sliding-window inference, config-declared metrics,
the validation loop.

Counterpart of ``lowlight_image_enhancement_tpu/training/validation.py``
(reference ``image_restoration_model.py:167-245`` tiling, ``:324-342``
``test()``, ``:416-428`` metric reflection):

- :func:`tiled_inference` -- overlapping fixed-size crops stitched back
  with overlap-count averaging: the same tile starts, the same averaging
  and the same ``batch_tiles`` zero-padding of the last tile batch;
- :func:`compute_metrics` -- the metrics of a ``val.metrics`` block,
  resolved by name through ``METRIC_REGISTRY``;
- :func:`validate` / :func:`strided_metric_sums` -- a val loader's images
  through the network on the device (NCHW), per-image metrics, means;
- :func:`allreduce_metric_sums` / :func:`dist_validate` -- each process of
  a ``torch.distributed`` world takes its stride of the images and one
  all-reduce sums the metric sums and counts (reference
  ``dist_validation``, ``image_restoration_model.py:344-468``);
- :func:`save_result_image`.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import metrics as _metrics  # noqa: F401  (registers the bridge names)
from lowlight_image_enhancement_tpu_torch.parallel.multihost import (
    host_info,
    rank_device,
)
from lowlight_image_enhancement_tpu_torch.utils.profiling import span
from lowlight_image_enhancement_tpu_torch.utils.registry import METRIC_REGISTRY


def _tile_starts(full: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, full) with a final flush-right tile."""
    if full <= tile:
        return [0]
    starts = list(range(0, full - tile + 1, stride))
    if starts[-1] != full - tile:
        starts.append(full - tile)
    return starts


def tiled_inference(
    forward: Callable[[np.ndarray], np.ndarray],
    img: np.ndarray,
    tile_size: int,
    overlap_ratio: float = 0.5,
    batch_tiles: int = 8,
) -> np.ndarray:
    """Sliding-window inference with overlap averaging (NHWC, N == 1).

    ``forward`` maps float32 ``[B, th, tw, C]`` numpy tiles to outputs of
    the same shape; every tile batch is zero-padded to ``batch_tiles``."""
    img = np.asarray(img, np.float32)
    n, h, w, c = img.shape
    if n != 1:
        raise ValueError("tiled_inference expects batch size 1")
    if h <= tile_size and w <= tile_size:
        return np.asarray(forward(img))

    stride = max(int(tile_size * (1.0 - overlap_ratio)), 1)
    ys = _tile_starts(h, min(tile_size, h), stride)
    xs = _tile_starts(w, min(tile_size, w), stride)
    th, tw = min(tile_size, h), min(tile_size, w)

    coords = [(y, x) for y in ys for x in xs]
    out = np.zeros((1, h, w, c), np.float32)
    cnt = np.zeros((1, h, w, 1), np.float32)
    for i in range(0, len(coords), batch_tiles):
        chunk = coords[i : i + batch_tiles]
        with span("validation.tiles"):
            tiles = np.stack([img[0, y : y + th, x : x + tw, :]
                              for (y, x) in chunk])
            pad = batch_tiles - len(chunk)
            if pad:
                tiles = np.concatenate(
                    [tiles, np.zeros((pad,) + tiles.shape[1:], tiles.dtype)])
        preds = np.asarray(forward(tiles))
        with span("validation.blend"):
            for j, (y, x) in enumerate(chunk):
                out[0, y : y + th, x : x + tw, :] += preds[j]
                cnt[0, y : y + th, x : x + tw, :] += 1.0
    with span("validation.blend"):
        return out / cnt


def compute_metrics(sr: torch.Tensor, gt: torch.Tensor,
                    metrics_opt: Mapping[str, Mapping[str, Any]]
                    ) -> Dict[str, float]:
    """Per-batch metrics (NCHW ``sr``, ``gt``) from a reference-style block::

        metrics:
          psnr_linear: {type: linear_psnr, data_range: 1.0}
    """
    results: Dict[str, float] = {}
    for name, opt in metrics_opt.items():
        opt = dict(opt)
        fn = METRIC_REGISTRY.get(opt.pop("type"))
        results[name] = float(fn(sr, gt, **opt))
    return results


def save_result_image(path: str, img: torch.Tensor) -> None:
    """Write an NCHW float [0,1] result (N == 1) as an 8-bit PNG."""
    from lowlight_image_enhancement_tpu_torch.utils import imgio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    hwc = img[0].permute(1, 2, 0).float().cpu().numpy()
    imgio.imwrite(path, imgio.to_uint8(hwc))


def validate(forward: Callable[[torch.Tensor], torch.Tensor],
             loader: Iterable[Mapping[str, Any]],
             metrics_opt: Mapping[str, Mapping[str, Any]],
             device: Any = "cuda", tile_size: Optional[int] = None,
             overlap_ratio: float = 0.5, max_images: Optional[int] = None,
             save_dir: Optional[str] = None) -> Dict[str, float]:
    """Metric means over the images of a loader of NHWC numpy batches with
    ``lq``/``gt`` (as the :class:`..data.Loader` yields them). ``forward``
    maps an NCHW float32 tensor on ``device`` to the restored NCHW tensor;
    with ``tile_size`` an image goes through :func:`tiled_inference`. With
    ``save_dir`` each result is written as ``<pair_id>.png``."""
    sums, count = strided_metric_sums(
        forward, loader, metrics_opt, device=device, tile_size=tile_size,
        overlap_ratio=overlap_ratio, max_images=max_images,
        save_dir=save_dir)
    if count == 0:
        return {}
    return {k: v / count for k, v in sums.items()}


def strided_metric_sums(forward: Callable[[torch.Tensor], torch.Tensor],
                        loader: Iterable[Mapping[str, Any]],
                        metrics_opt: Mapping[str, Mapping[str, Any]],
                        device: Any = "cuda",
                        tile_size: Optional[int] = None,
                        overlap_ratio: float = 0.5,
                        max_images: Optional[int] = None,
                        save_dir: Optional[str] = None, rank: int = 0,
                        world: int = 1):
    """Metric SUMS and the image count over this rank's stride of the val
    set (the images at global index ``i`` with ``i % world == rank``)."""
    dev = torch.device(device)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, np.float32)).to(dev).permute(0, 3, 1, 2).contiguous()

    def forward_nhwc(tiles: np.ndarray) -> np.ndarray:
        return forward(to_dev(tiles)).float().permute(0, 2, 3, 1).cpu().numpy()

    sums: Dict[str, float] = {}
    count = gidx = 0
    for batch in loader:
        lq, gt = np.asarray(batch["lq"]), np.asarray(batch["gt"])
        names = batch.get("pair_id")
        for i in range(lq.shape[0]):
            this_idx, gidx = gidx, gidx + 1
            if this_idx % world != rank:
                continue
            img = lq[i:i + 1]
            if tile_size:
                sr = to_dev(tiled_inference(forward_nhwc, img, tile_size,
                                            overlap_ratio))
            else:
                sr = forward(to_dev(img)).float()
            if save_dir:
                name = names[i] if names is not None else f"img_{this_idx:05d}"
                save_result_image(f"{save_dir}/{name}.png", sr)
            per = compute_metrics(sr, to_dev(gt[i:i + 1]), metrics_opt)
            for k, v in per.items():
                sums[k] = sums.get(k, 0.0) + v
            count += 1
            if max_images and count >= max_images:
                return sums, count
    return sums, count


def allreduce_metric_sums(sums: Dict[str, float], count: int):
    """Sum per-rank metric sums and image counts over the processes of the
    ``torch.distributed`` world: one all-reduce of the stacked sums and
    count (fp64, on this rank's device). Every rank gets the global
    result. Identity for one process.

    The metric names are gathered first: a rank whose stride holds no
    image (fewer images than ranks) has no sums, and a stack of another
    length would fail the all-reduce or hang it."""
    _, world, _ = host_info()
    if world == 1:
        return dict(sums), count
    names: List[Optional[List[str]]] = [None] * world
    torch.distributed.all_gather_object(names, sorted(sums))
    keys = sorted(set().union(*names))
    local = torch.tensor([sums.get(k, 0.0) for k in keys] + [float(count)],
                         dtype=torch.float64, device=rank_device())
    torch.distributed.all_reduce(local)
    total = local.cpu().tolist()
    return {k: total[i] for i, k in enumerate(keys)}, int(round(total[-1]))


def dist_validate(forward: Callable[[torch.Tensor], torch.Tensor],
                  loader: Iterable[Mapping[str, Any]],
                  metrics_opt: Mapping[str, Mapping[str, Any]],
                  **kwargs) -> Dict[str, float]:
    """Validation over the processes of the world: each takes the images
    at global index ``i % world == rank``, the sums are all-reduced and
    every process returns the global means (``validate`` for one
    process). ``kwargs`` go to :func:`strided_metric_sums`."""
    rank, world, _ = host_info()
    sums, count = strided_metric_sums(forward, loader, metrics_opt,
                                      rank=rank, world=world, **kwargs)
    sums, count = allreduce_metric_sums(sums, count)
    if count == 0:
        return {}
    return {k: v / count for k, v in sums.items()}
