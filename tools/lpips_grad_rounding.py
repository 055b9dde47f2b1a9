#!/usr/bin/env python
"""How far the LPIPS-vgg input gradient moves with fp32 rounding.

The gradient of LPIPS (a VGG16 trunk with ReLUs and max pools) is
piecewise smooth: where a ReLU input or a max-pool pair lies within fp32
rounding of its switch, two fp32 computations route a region of the input
gradient apart. This tool takes the port's ``LPIPSNet(net="vgg")`` (its
seeded random trunk) on six seeded 2x3x128^2 input pairs (a uniform target
and a prediction 0.2 N(0, 1) away, clipped to [0, 1]) and prints, per
seed, how the fp32 gradient on the CPU -- and on the card when there is
one -- differs from the fp64 gradient on the CPU: ``max|d| / max|g|``,
``|d|_2 / |g|_2`` and the share of elements with ``|d| > 1e-4 max|g|``;
and for seed 0 how far the card's fp32 trunk taps lie from fp64.

    python tools/lpips_grad_rounding.py
"""

from __future__ import annotations

import copy
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

from lowlight_image_enhancement_tpu_torch.models.lpips import (  # noqa: E402
    load_lpips,
)

SEEDS = range(6)


def input_grad(module, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """d mean(LPIPS(p, t)) / dp in the module's dtype, as fp64 on the host."""
    p = p.clone().requires_grad_(True)
    v = module(p.clamp(0, 1) * 2 - 1, t.clamp(0, 1) * 2 - 1).mean()
    return torch.autograd.grad(v, p)[0].double().cpu()


def stats(g: torch.Tensor, ref: torch.Tensor) -> str:
    d = (g - ref).abs()
    top = ref.abs().max()
    return (f"max {float(d.max() / top):.2e} l2 "
            f"{float(d.norm() / ref.norm()):.2e} share>1e-4 "
            f"{float((d > 1e-4 * top).double().mean()):.2e}")


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu32, _ = load_lpips(net="vgg")
    cpu64 = copy.deepcopy(cpu32).double()
    card = (copy.deepcopy(cpu32).cuda() if torch.cuda.is_available()
            else None)
    if card is not None:
        print(torch.cuda.get_device_name(0))
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)
        t = torch.rand(2, 3, 128, 128, generator=gen)
        p = (t + 0.2 * torch.randn(t.shape, generator=gen)).clamp(0, 1)
        ref = input_grad(cpu64, p.double(), t.double())
        line = (f"seed {seed}: cpu fp32 vs cpu fp64 "
                f"{stats(input_grad(cpu32, p, t), ref)}")
        if card is not None:
            line += (" | card fp32 vs cpu fp64 "
                     + stats(input_grad(card, p.cuda(), t.cuda()), ref))
        print(line, flush=True)
        if seed == 0 and card is not None:
            with torch.no_grad():
                xc = (p.cuda() * 2 - 1 - card.shift) / card.scale
                x64 = (p.double() * 2 - 1 - cpu64.shift) / cpu64.scale
                for k, (a, b) in enumerate(zip(card.trunk(xc),
                                               cpu64.trunk(x64))):
                    e = (a.double().cpu() - b).abs().max() / b.abs().max()
                    print(f"  tap {k}: card fp32 vs cpu fp64 {float(e):.2e}")


if __name__ == "__main__":
    main()
