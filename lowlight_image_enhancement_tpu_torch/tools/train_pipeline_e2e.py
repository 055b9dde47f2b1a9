"""Can the input pipeline keep the card busy? Three rates in one process
(counterpart of ``tools/train_pipeline_e2e.py``)::

    python -m lowlight_image_enhancement_tpu_torch.tools.train_pipeline_e2e \
        [--steps 100] [--workers 2] [--pairs 8] [--json out.json]

1. A synthetic SID pack on disk (uint16 frames, banded zlib: the
   production decode path of ``data/records.py``).
2. Measured one after another:
   - ``loader_only``: ``Loader(num_workers=W)`` with random 384^2 crops
     and augmentation, on the host -- the host's ceiling;
   - ``device_only``: the full-width bf16 no-perc hybrid train step on one
     device-resident 2x384^2 batch, each step on the state of the one
     before -- the card's ceiling;
   - ``end_to_end``: ``Loader`` -> ``prefetch_to_device`` -> train step --
     the rate a user sees.
3. Their ratios: ``wall/device`` and ``wall/min(host, device)`` (how much
   of the slower side the overlap keeps).

Each device rate ends in ``torch.cuda.synchronize()``. ``--width``
shrinks the network for a CPU run.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict

import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.data import Loader, SonySIDDataset
from lowlight_image_enhancement_tpu_torch.data.pipeline import (
    epochs,
    prefetch_to_device,
)
from lowlight_image_enhancement_tpu_torch.losses import HybridLossPlus
from lowlight_image_enhancement_tpu_torch.ops.psf import create_crosstalk_psf
from lowlight_image_enhancement_tpu_torch.tools.common import (
    add_device_arg,
    flagship_net,
    nchw,
    sync,
    synthetic_pack,
)
from lowlight_image_enhancement_tpu_torch.training.schedules import (
    make_schedule,
)
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    create_train_state,
    make_optimizer,
    make_train_step,
)


def hybrid_step(net, dev: torch.device):
    """``(state, step)`` of the no-perc hybrid recipe on ``net``."""
    loss = HybridLossPlus(
        use_perc=False, use_deltaE=True, use_ssim=False,
        physics_psf_module=create_crosstalk_psf("mono", "P2")).to(dev)
    tx = make_optimizer(make_schedule(
        {"type": "TrueCosineAnnealingLR", "T_max": 300000,
         "eta_min": 1e-6}, base_lr=5e-4))
    return (create_train_state(net, tx, loss=loss),
            make_train_step(net, loss, tx))


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--patch", type=int, default=384)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--frame-size", type=int, default=512)
    ap.add_argument("--comp", default="zlib_band")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--json", default=None)
    ap.add_argument("--width", type=int, default=32)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as root:
        manifest = synthetic_pack(root, args.pairs, args.frame_size,
                                  args.comp)
        ds = SonySIDDataset(
            manifest, subset="train", phase="train",
            patch_size=args.patch, samples_per_pair=64,
            random_crop=True, use_augment=True,
            io_backend={"type": "pack",
                        "short_path": f"{root}/short.pack",
                        "long_path": f"{root}/long.pack"},
        )
        loader = Loader(ds, batch_size=args.batch_size, shuffle=True,
                        num_workers=args.workers)

        # --- 1. host-only ceiling ---
        n_host = min(args.steps, 48)
        it = epochs(loader)
        next(it)  # warm caches / open packs
        t0 = time.perf_counter()
        for _ in range(n_host):
            first = next(it)
        host_sps = n_host / (time.perf_counter() - t0)
        it.close()

        # --- 2. device-only ceiling (chained, one resident batch) ---
        net = flagship_net(dev, torch.bfloat16, width=args.width)
        state, step = hybrid_step(net, dev)
        dev_batch = nchw(first, dev)
        for _ in range(3):
            state, logs = step(state, dev_batch)
        sync(dev)
        n_dev = min(args.steps, 60)
        t0 = time.perf_counter()
        for _ in range(n_dev):
            state, logs = step(state, dev_batch)
        sync(dev)
        dev_sps = n_dev / (time.perf_counter() - t0)

        # --- 3. end-to-end: loader -> prefetch -> step ---
        stream = prefetch_to_device(epochs(loader), device=dev, size=2)
        state2, step2 = hybrid_step(
            flagship_net(dev, torch.bfloat16, width=args.width, seed=1),
            dev)
        for _ in range(2):  # warm-up
            state2, logs = step2(state2, next(stream))
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state2, logs = step2(state2, next(stream))
        sync(dev)
        wall_sps = args.steps / (time.perf_counter() - t0)
        stream.close()

    bytes_per_item = 2 * (args.frame_size ** 2) * 3 * 2  # short+long u16
    result = {
        "protocol": {
            "patch": args.patch, "batch_size": args.batch_size,
            "frame_size": args.frame_size, "comp": args.comp,
            "workers": args.workers, "steps": args.steps,
            "nproc": os.cpu_count(), "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "width": args.width,
        },
        "host_only_steps_per_sec": host_sps,
        "host_only_items_per_sec": host_sps * args.batch_size,
        "host_decoded_mb_per_sec":
            host_sps * args.batch_size * bytes_per_item / 1e6,
        "device_only_steps_per_sec": dev_sps,
        "end_to_end_steps_per_sec": wall_sps,
        "wall_over_device": wall_sps / dev_sps,
        "wall_over_bound": wall_sps / min(host_sps, dev_sps),
        "bound": "host" if host_sps < dev_sps else "device",
        "l_total": float(logs["l_total"]),
    }
    print(json.dumps(result, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
