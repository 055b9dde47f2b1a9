"""Seeded weights, made on the device in one draw.

Every tensor of a parameter set is cut from one ``torch.rand`` of the
set's total size on the device's own generator, in the order of its
shapes, then scaled by its kind: a convolution's weight and bias uniform
in +-1/sqrt(fan in) (PyTorch's default bound), a LayerNorm's (a leaf
under a ``norm`` module) weight 1 +- 0.1 and bias +- 0.1, the residual
scales ``beta`` and ``gamma`` uniform in [0, 2 s] (``s`` the
configuration's ``assumed.residual_scale``: NAFNet initialises them to 0,
which would make every block the identity), VGG19's convolutions
He-uniform with zero bias. A reference's ``init`` decides first, for the
leaves it knows.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Optional

import torch


def subseed(seed: int, tag: str, bits: int = 63) -> int:
    """A seed for one use, derived from the run's ``--seed`` and a tag."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> (64 - bits)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:]))


Init = Callable[[str, tuple, torch.Tensor], Optional[torch.Tensor]]


def _default(name: str, u: torch.Tensor, shapes: Dict[str, tuple],
             residual_scale: Optional[float], he: bool) -> torch.Tensor:
    """A leaf's value from its uniform draw ``u`` by the module docstring's
    rules."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("beta", "gamma"):
        if residual_scale is None:
            raise ValueError(f"{name}: a residual scale needs the "
                             "configuration's assumed.residual_scale")
        return u * (2.0 * residual_scale)
    if ".norm" in name or name.startswith("norm"):
        return (1.0 if leaf == "weight" else 0.0) + 0.2 * (u - 0.5)
    if he:
        fan = _fan_in(u.shape) if leaf == "weight" else 1
        return ((u - 0.5) * 2.0 * math.sqrt(6.0 / fan) if leaf == "weight"
                else torch.zeros_like(u))
    weight = name[:-len("bias")] + "weight"
    if leaf != "weight" and (leaf != "bias" or weight not in shapes):
        raise KeyError(f"{name}: no default rule for this leaf; the "
                       "reference's init has to give it")
    fan = _fan_in(u.shape if leaf == "weight" else shapes[weight])
    return (u - 0.5) * (2.0 / math.sqrt(fan))


@torch.no_grad()
def make_params(shapes: Dict[str, tuple], seed: int, tag: str, device,
                residual_scale: Optional[float] = None, he: bool = False,
                init: Optional[Init] = None) -> Dict[str, torch.Tensor]:
    """fp32 tensors of ``shapes`` on ``device``; ``he`` picks the VGG
    rule for convolutions; ``init(name, shape, u)``, where given, sets
    the leaves it returns a tensor for."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator(seed, tag, device),
                      device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = flat[off:off + n].view(shape)
        off += n
        t = init(name, shape, u) if init is not None else None
        if t is None:
            t = _default(name, u, shapes, residual_scale, he)
        out[name] = t.contiguous()
    return out
