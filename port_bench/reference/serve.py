"""What a restoration server returns for an image, worked out plainly.

An image no larger than ``max_bucket`` on either side is zero-padded at
the bottom and right to the bucket grid (multiples of ``bucket_step``, at
least ``min_bucket``; the largest height and width of the images that
share the bucket), restored, and cropped back. A larger image is restored
in overlapping ``max_bucket`` tiles (stride ``tile * (1 - overlap)``, a
last tile flush with the far edge) whose outputs are averaged where they
overlap. No operation of the network mixes two images of a batch, so each
image or tile is restored on its own here.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

Forward = Callable[[torch.Tensor], torch.Tensor]


def bucket_dim(size: int, step: int, min_size: int) -> int:
    return -(-max(size, min_size) // step) * step


def tile_starts(full: int, tile: int, stride: int) -> List[int]:
    if full <= tile:
        return [0]
    starts = list(range(0, full - tile + 1, stride))
    if starts[-1] != full - tile:
        starts.append(full - tile)
    return starts


def restore_bucketed(forward: Forward, img: torch.Tensor, bh: int,
                     bw: int) -> torch.Tensor:
    """``img`` [3, H, W] padded with zeros to ``bh x bw``, restored,
    cropped back."""
    _, h, w = img.shape
    x = F.pad(img, (0, bw - w, 0, bh - h))[None]
    return forward(x)[0, :, :h, :w]


def restore_tiled(forward: Forward, img: torch.Tensor, tile: int,
                  overlap: float) -> torch.Tensor:
    _, h, w = img.shape
    stride = max(int(tile * (1.0 - overlap)), 1)
    th, tw = min(tile, h), min(tile, w)
    out = torch.zeros_like(img)
    cnt = torch.zeros((1, h, w), dtype=img.dtype, device=img.device)
    for y in tile_starts(h, th, stride):
        for x in tile_starts(w, tw, stride):
            out[:, y:y + th, x:x + tw] += forward(
                img[None, :, y:y + th, x:x + tw])[0]
            cnt[:, y:y + th, x:x + tw] += 1.0
    return out / cnt


def restore_call(forward: Forward, images: Sequence[torch.Tensor],
                 server: dict) -> List[torch.Tensor]:
    """The outputs of one call over ``images`` ([3, H, W] each), with the
    server settings ``bucket_step``, ``min_bucket``, ``max_bucket``,
    ``tile_overlap``."""
    step, lo = server["bucket_step"], server["min_bucket"]
    small = [im for im in images if max(im.shape[1:]) <= server["max_bucket"]]
    out = []
    for im in images:
        if max(im.shape[1:]) > server["max_bucket"]:
            out.append(restore_tiled(forward, im, server["max_bucket"],
                                     server["tile_overlap"]))
            continue
        # the bucket of every image that shares this one's key
        key = (bucket_dim(im.shape[1], step, lo),
               bucket_dim(im.shape[2], step, lo))
        mates = [m for m in small
                 if (bucket_dim(m.shape[1], step, lo),
                     bucket_dim(m.shape[2], step, lo)) == key]
        bh = bucket_dim(max(m.shape[1] for m in mates), step, lo)
        bw = bucket_dim(max(m.shape[2] for m in mates), step, lo)
        out.append(restore_bucketed(forward, im, bh, bw))
    return out
