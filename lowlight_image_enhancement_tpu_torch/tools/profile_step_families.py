"""Trace the flagship train step and print time per kernel family
(counterpart of ``tools/profile_step_families.py``)::

    python -m lowlight_image_enhancement_tpu_torch.tools.profile_step_families \
        [--perc] [--top N] [--logdir DIR]

The recipe of ``profile_step_families.py:44-73``: ``NewBPNAFNet`` at
width 32 in bf16, ``HybridLossPlus`` with DeltaE00 and the P2 sRGB physics
term (``--perc`` adds the perceptual term on a bf16 VGG19 trunk), AdamW on
the cosine schedule 5e-4 -> 1e-6, a seeded 2x3x512x512 batch. Three
warm-up steps, then five under ``utils.profiling.trace``; prints
``summarize_trace`` per step: the device kernels' families, or the host's
operators where the trace has no device time (a CPU run).
``--size`` and ``--width`` shrink the run.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.losses import HybridLossPlus
from lowlight_image_enhancement_tpu_torch.ops.psf import create_crosstalk_psf
from lowlight_image_enhancement_tpu_torch.tools.common import (
    add_device_arg,
    flagship_net,
    nchw,
    sync,
)
from lowlight_image_enhancement_tpu_torch.training.schedules import (
    make_schedule,
)
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from lowlight_image_enhancement_tpu_torch.utils.profiling import (
    summarize_trace,
    trace,
)

TRACED_STEPS = 5


def step_batch(n: int, s: int, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The seeded batch of ``profile_step_families.py:75-88``, NCHW."""
    rng = np.random.default_rng(0)
    short_raw = rng.uniform(0, 0.2, (n, s, s, 3)).astype(np.float32)
    ratio = np.full((n,), 5.0, np.float32)
    lq = np.clip(short_raw * ratio[:, None, None, None], 0, 1
                 ).astype(np.float32)
    gt = np.clip(lq + 0.02, 0, 1).astype(np.float32)
    return nchw({"lq": lq, "gt": gt, "short_raw": short_raw, "long_raw": gt,
                 "short_obs": short_raw, "expo_ratio": ratio}, dev)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--perc", action="store_true")
    ap.add_argument("--top", type=int, default=28)
    ap.add_argument("--logdir", default=None,
                    help="trace directory (default: a new temporary one)")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--width", type=int, default=32)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    net = flagship_net(dev, torch.bfloat16, width=args.width)
    loss = HybridLossPlus(
        use_perc=args.perc, use_deltaE=True, use_ssim=False,
        perc_dtype=torch.bfloat16,
        physics_psf_module=create_crosstalk_psf("mono", "P2")).to(dev)
    tx = make_optimizer(make_schedule(
        {"type": "TrueCosineAnnealingLR", "T_max": 300000,
         "eta_min": 1e-6}, base_lr=5e-4))
    state = create_train_state(net, tx, loss=loss)
    step = make_train_step(net, loss, tx)
    batch = step_batch(2, args.size, dev)

    for _ in range(3):
        state, logs = step(state, batch)
    sync(dev)

    logdir = args.logdir or tempfile.mkdtemp(prefix="step_trace_")
    os.makedirs(logdir, exist_ok=True)
    with trace(logdir):
        for _ in range(TRACED_STEPS):
            state, logs = step(state, batch)
        sync(dev)

    fam = summarize_trace(logdir, top=args.top)
    total = sum(fam.values())
    kind = "device" if dev.type == "cuda" else "host (cpu_op)"
    print(f"{kind} total over {TRACED_STEPS} steps: {total:.2f} ms "
          f"-> {total / TRACED_STEPS:.2f} ms/step  (perc={args.perc})")
    per_step = {name: ms / TRACED_STEPS for name, ms in fam.items()}
    for name, ms in per_step.items():
        print(f"  {ms:7.3f} ms/step  {name}")
    return {"device": str(dev), "logdir": logdir,
            "ms_per_step": total / TRACED_STEPS,
            "families_ms_per_step": per_step,
            "l_total": float(logs["l_total"])}


if __name__ == "__main__":
    main()
