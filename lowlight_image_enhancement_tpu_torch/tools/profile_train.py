"""Decompose the SID train-step cost on the card: forward vs backward vs
loss terms vs optimizer (counterpart of ``tools/profile_train.py``)::

    python -m lowlight_image_enhancement_tpu_torch.tools.profile_train \
        [--only fwd,gl1,l1_only,l1+phys,l1+deltaE,full]

The flagship ``NewBPNAFNet`` (width 32, (2,2,4,8)/12/(2,2,2,2), bf16) on a
seeded 2x3x512x512 batch: the chained forward (each output is the next
input), ``grad(L1)`` of every parameter, and the train step (AdamW 1e-4,
clip 0.01) with each of four ``HybridLossPlus`` subsets, each step on the
state the one before it left. Every timed run ends in
``torch.cuda.synchronize()``. ``--size``, ``--width``, ``--dtype``,
``--runs`` and ``--weights`` (a ``.pth`` or a ``.npz`` of
JAX params) shrink or pin the run; each subset starts from the same
weights.
"""

from __future__ import annotations

import argparse
import copy
import time
from typing import Any, Dict

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.losses import HybridLossPlus
from lowlight_image_enhancement_tpu_torch.ops.psf import create_crosstalk_psf
from lowlight_image_enhancement_tpu_torch.tools.common import (
    DTYPES,
    add_device_arg,
    flagship_net,
    nchw,
    sync,
)
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    create_train_state,
    make_optimizer,
    make_train_step,
)

# the four loss subsets: HybridLossPlus keywords (no perceptual term)
LOSSES = {
    "l1_only": dict(use_deltaE=False, use_ssim=False, use_phys=False),
    "l1+phys": dict(use_deltaE=False, use_ssim=False, phys=True),
    "l1+deltaE": dict(use_deltaE=True, use_ssim=False, use_phys=False),
    "full": dict(use_deltaE=True, use_ssim=False, phys=True),
}


def make_loss(name: str, dev: torch.device) -> HybridLossPlus:
    kw = dict(LOSSES[name])
    if kw.pop("phys", False):
        kw["physics_psf_module"] = create_crosstalk_psf("mono")
    return HybridLossPlus(use_perc=False, **kw).to(dev)


def make_batch(n: int, s: int, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The tool's seeded batch (``profile_train.py:92-98``), NCHW."""
    rng = np.random.default_rng(0)
    draw = lambda lo, hi: rng.uniform(  # noqa: E731
        lo, hi, (n, s, s, 3)).astype(np.float32)
    x, gt, short = draw(0, 1), draw(0, 1), draw(0, 0.2)
    return nchw({"lq": x, "gt": gt, "short_raw": short, "long_raw": gt,
                 "short_obs": short,
                 "expo_ratio": np.full((n,), 5.0, np.float32)}, dev)


def timed(fn, runs: int, warmup: int, dev: torch.device) -> float:
    """ms per call of ``fn`` over ``runs`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / runs * 1e3


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated subset: fwd,gl1,l1_only,l1+phys,"
                         "l1+deltaE,full")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--runs", type=int, default=None,
                    help="timed calls of each measurement (default 20 for "
                         "fwd and gl1, 10 for the steps)")
    ap.add_argument("--weights", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    dev = resolve_device(args.device)

    def want(name):
        return only is None or name in only

    n, s = 2, args.size
    net = flagship_net(dev, DTYPES[args.dtype], args.weights,
                       width=args.width)
    init = copy.deepcopy(net.state_dict())
    batch = make_batch(n, s, dev)
    x, gt = batch["lq"], batch["gt"]
    warmup = 3
    out: Dict[str, Any] = {
        "device": str(dev), "shape": [n, 3, s, s], "width": args.width,
        "dtype": args.dtype, "train_step_ms": {}, "first_l_total": {},
        "calls": {}}

    if want("fwd"):
        runs = args.runs or 20
        y = [x]

        @torch.no_grad()
        def fwd():
            y[0] = net(y[0]).to(x.dtype)

        out["forward_ms"] = timed(fwd, runs, warmup, dev)
        out["calls"]["fwd"] = runs + warmup
        print(f"forward b{n} {s}^2 (chained):  {out['forward_ms']:8.2f} ms",
              flush=True)

    if want("gl1"):
        runs = args.runs or 20
        params = list(net.parameters())

        def g_l1():
            return torch.autograd.grad(
                (net(x).float() - gt).abs().mean(), params)

        out["grad_l1_ms"] = timed(g_l1, runs, warmup, dev)
        out["calls"]["gl1"] = runs + warmup
        print(f"grad(L1) fwd+bwd (unchained):{out['grad_l1_ms']:8.2f} ms",
              flush=True)

    for name in LOSSES:
        if not want(name):
            continue
        runs = args.runs or 10
        loss = make_loss(name, dev)
        net.load_state_dict(init)
        tx = make_optimizer(1e-4)
        state = create_train_state(net, tx, loss=loss)
        step = make_train_step(net, loss, tx)
        first = []

        def one_step():
            nonlocal state
            state, logs = step(state, batch)
            if not first:
                first.append(float(logs["l_total"]))

        ms = timed(one_step, runs, warmup, dev)
        out["train_step_ms"][name] = ms
        out["first_l_total"][name] = first[0]
        out["calls"][name] = runs + warmup
        print(f"train_step [{name:12s}] (chained):  {ms:8.2f} ms",
              flush=True)
    return out


if __name__ == "__main__":
    main()
