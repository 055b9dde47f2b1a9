"""Seeded weights, made on the device in one draw.

Every tensor of a parameter set is cut from one ``torch.rand`` of the
set's total size on the device's own generator, then scaled by its kind:
a convolution's weight and bias uniform in +-1/sqrt(fan in) (PyTorch's
default bound), a LayerNorm's weight 1 +- 0.1 and bias +- 0.1, the
residual scales ``beta`` and ``gamma`` uniform in [0, 2 s] (``s`` from the
configuration: NAFNet initialises them to 0, which would make every block
the identity), VGG19's convolutions He-uniform with zero bias.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch


def subseed(seed: int, tag: str, bits: int = 63) -> int:
    """A seed for one use, derived from the run's ``--seed`` and a tag."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> (64 - bits)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:]))


@torch.no_grad()
def make_params(shapes: Dict[str, tuple], seed: int, tag: str, device,
                residual_scale: float = 0.1, he: bool = False
                ) -> Dict[str, torch.Tensor]:
    """fp32 tensors of ``shapes`` on ``device``; ``he`` picks the VGG
    rule for convolutions."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator(seed, tag, device),
                      device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = flat[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("beta", "gamma"):
            t = u * (2.0 * residual_scale)
        elif ".norm" in name:
            t = (1.0 if leaf == "weight" else 0.0) + 0.2 * (u - 0.5)
        elif he:
            fan = _fan_in(shape) if leaf == "weight" else 1
            t = ((u - 0.5) * 2.0 * math.sqrt(6.0 / fan) if leaf == "weight"
                 else torch.zeros_like(u))
        else:
            fan = _fan_in(shape if leaf == "weight"
                          else shapes[name[:-len("bias")] + "weight"])
            t = (u - 0.5) * (2.0 / math.sqrt(fan))
        out[name] = t.contiguous()
    return out
