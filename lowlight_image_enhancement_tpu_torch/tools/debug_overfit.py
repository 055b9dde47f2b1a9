"""Single-batch overfit harness (counterpart of ``tools/debug_overfit.py``):
the "8x8 first" closed loop -- a tiny NAFNet (width 8, (1,1)/1/(1,1)) must
drive the loss down on one fixed batch, first with plain L1, then with the
hybrid escalation (L1 + DeltaE00 + SSIM + sRGB physics). Run before any
real training::

    python -m lowlight_image_enhancement_tpu_torch.tools.debug_overfit \
        [--steps 200] [--size 32] [--device cpu]

``--weights`` (a ``.pth`` or a ``.npz`` of JAX params) starts both phases
from given weights instead of the seeded ones.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.demo import load_weights
from lowlight_image_enhancement_tpu_torch.losses import HybridLossPlus
from lowlight_image_enhancement_tpu_torch.models import NAFNet
from lowlight_image_enhancement_tpu_torch.ops.psf import create_crosstalk_psf
from lowlight_image_enhancement_tpu_torch.tools.common import (
    add_device_arg,
    nchw,
    seeded,
)
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    create_train_state,
    make_optimizer,
    make_train_step,
)


def make_batch(size: int, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The fixed batch of ``debug_overfit.py:42-52``, NCHW."""
    rng = np.random.default_rng(0)
    short_raw = rng.uniform(0, 0.1, (2, size, size, 3)).astype(np.float32)
    ratio = np.full((2,), 10.0, np.float32)
    lq = np.clip(short_raw * ratio[:, None, None, None], 0, 1)
    gt = np.clip(lq + 0.05 * rng.standard_normal(lq.shape), 0, 1
                 ).astype(np.float32)
    return nchw({"lq": lq, "gt": gt, "short_raw": short_raw, "long_raw": gt,
                 "short_obs": short_raw, "expo_ratio": ratio}, dev)


def run(loss_name: str, steps: int, size: int, dev: torch.device,
        weights: Optional[str] = None) -> List[float]:
    """One phase; returns ``l_total`` of every step."""
    net = seeded(lambda: NAFNet(img_channel=3, width=8, middle_blk_num=1,
                                enc_blk_nums=(1, 1), dec_blk_nums=(1, 1)))
    if weights:
        load_weights(net, weights)
    net = net.to(dev)
    if loss_name == "l1":
        loss = HybridLossPlus(use_perc=False, use_deltaE=False,
                              use_ssim=False, use_phys=False)
    else:
        loss = HybridLossPlus(use_perc=False, use_deltaE=True, use_ssim=True,
                              physics_psf_module=create_crosstalk_psf("mono"))
    loss = loss.to(dev)
    tx = make_optimizer(2e-3, grad_clip_norm=1.0)
    state = create_train_state(net, tx, loss=loss)
    step = make_train_step(net, loss, tx)
    batch = make_batch(size, dev)

    vals = []
    for i in range(steps):
        state, logs = step(state, batch)
        vals.append(float(logs["l_total"]))
        if (i + 1) % max(steps // 10, 1) == 0:
            print(f"  step {i + 1:4d}: l_total={vals[-1]:.5f}")
    first, last = vals[0], vals[-1]
    print(f"[{loss_name}] {first:.5f} -> {last:.5f} "
          f"({'OK: decreased' if last < first else 'FAIL: no decrease'})")
    return vals


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--weights", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    print("phase 1: L1-only overfit")
    out["l1"] = run("l1", args.steps, args.size, dev, args.weights)
    print("phase 2: hybrid escalation (L1+deltaE+SSIM+phys)")
    out["hybrid"] = run("hybrid", args.steps, args.size, dev, args.weights)
    return out


if __name__ == "__main__":
    main()
