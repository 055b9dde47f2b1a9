"""Tiled sliding-window inference, counterpart of
``lowlight_image_enhancement_tpu/training/validation.py:tiled_inference``.

Overlapping fixed-size crops, stitched back with overlap-count averaging:
the same tile starts, the same averaging and the same ``batch_tiles``
zero-padding of the last tile batch as the JAX version.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


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
        tiles = np.stack([img[0, y : y + th, x : x + tw, :] for (y, x) in chunk])
        pad = batch_tiles - len(chunk)
        if pad:
            tiles = np.concatenate(
                [tiles, np.zeros((pad,) + tiles.shape[1:], tiles.dtype)])
        preds = np.asarray(forward(tiles))
        for j, (y, x) in enumerate(chunk):
            out[0, y : y + th, x : x + tw, :] += preds[j]
            cnt[0, y : y + th, x : x + tw, :] += 1.0
    return out / cnt
