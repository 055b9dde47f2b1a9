"""Pieces the tools share: the flagship network and batch, seeded
weights, and a synthetic SIDPack pair."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch.data.records import SidPackWriter
from lowlight_image_enhancement_tpu_torch.demo import load_weights
from lowlight_image_enhancement_tpu_torch.models import create_newbp_net

# NewBPNAFNet's published SID configuration (configs/sid_newbp_mono.yml)
FLAGSHIP = dict(img_channel=3, width=32, enc_blk_nums=(2, 2, 4, 8),
                middle_blk_num=12, dec_blk_nums=(2, 2, 2, 2))
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")


def seeded(build, seed: int = 0):
    """``build()`` with PyTorch's default generator at ``seed`` (the
    modules draw their initial weights there), the caller's state kept."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def flagship_net(dev: torch.device, dtype: torch.dtype = torch.bfloat16,
                 weights: Optional[str] = None, seed: int = 0,
                 **nafnet: Any):
    """The flagship ``NewBPNAFNet`` (``nafnet`` overrides its
    ``FLAGSHIP`` keys) on ``dev``: initial weights seeded by ``seed``, or
    ``weights`` (a ``.pth`` state_dict or a ``.npz`` of JAX params)."""
    params = {**FLAGSHIP, **nafnet}
    net = seeded(lambda: create_newbp_net(nafnet_params=params, dtype=dtype,
                                          device="cpu"), seed)
    if weights:
        load_weights(net, weights)
    return net.to(dev)


def nchw(batch: Dict[str, Any], dev: torch.device) -> Dict[str, torch.Tensor]:
    """The numeric arrays of a numpy batch as tensors on ``dev``, NHWC
    images as NCHW."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            t = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            out[k] = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
    return out


def synthetic_pack(root: str, pairs: int, size: int, comp: str,
                   prefix: str = "") -> str:
    """``{root}/{prefix}short.pack`` and ``long.pack`` of ``pairs`` seeded
    uint16 frames (long in [0, 4096), short = long // 100) and their
    manifest; returns the manifest's path."""
    rng = np.random.default_rng(0)
    records: List[dict] = []
    with SidPackWriter(f"{root}/{prefix}short.pack", comp=comp) as ws, \
            SidPackWriter(f"{root}/{prefix}long.pack", comp=comp) as wl:
        for i in range(pairs):
            img = rng.integers(0, 4096, (size, size, 3)).astype(np.uint16)
            key = f"p{i:05d}"
            ws.add(key, (img // 100).astype(np.uint16))
            wl.add(key, img)
            records.append({
                "pair_id": key, "subset": "train",
                "short_key": key, "long_key": key,
                "short_exposure": 0.1, "long_exposure": 10.0,
                "exposure_ratio": 100.0,
            })
    manifest = os.path.join(root, f"{prefix}manifest.json")
    with open(manifest, "w") as f:
        json.dump(records, f)
    return manifest


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
