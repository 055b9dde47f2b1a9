"""The yardstick's arithmetic: the H100's peaks, a NAFBlock's operations
and bytes at its shapes, and a network's forward FLOPs (any architecture:
counted over its plain reference's ``forward``).

A NAFBlock's count is of its math, whatever route or kernel computes it:
the products of conv1 (C -> 2C), the depthwise 3x3 (2C), conv3 (C -> C),
conv4 (C -> 2C), conv5 (C -> C) per pixel and the SCA 1x1 per image, at
2 operations a multiply-add; the backward computes each product's input
and weight gradients, twice the forward's. Bytes count each input read
once and each output written once: the activations in the activation
type, the parameters and their gradients in fp32 as the module keeps
them. Elementwise work and LayerNorm are left out of the operations, so
the bound is a lower bound of the time.
"""

from __future__ import annotations

import json
from functools import lru_cache
from types import ModuleType
from typing import Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def block_params(c: int) -> int:
    """Parameters of a NAFBlock of C channels (dw and FFN expansion 2)."""
    return (2 * c * c + 2 * c) + (18 * c + 2 * c) + 2 * (c * c + c) \
        + (2 * c * c + 2 * c) + (c * c + c) + 4 * c + 2 * c


def block_work(n: int, c: int, h: int, w: int, dtype: str,
               backward: bool = False) -> Tuple[float, float]:
    """``(flops, bytes)`` of one NAFBlock call on ``[n, c, h, w]``."""
    px = n * h * w
    flops = 2.0 * (px * (6 * c * c + 18 * c) + n * c * c)
    act = float(px * c * ELEMENT_BYTES[dtype])
    if not backward:
        return flops, 2 * act + 4.0 * block_params(c)
    # x and dy in, dx out; the parameters in, their gradients out
    return 2 * flops, 3 * act + 8.0 * block_params(c)


def block_bound_s(n: int, c: int, h: int, w: int, dtype: str,
                  backward: bool = False) -> float:
    """Least time of one call: operations at the dtype's peak against
    bytes at the HBM rate."""
    flops, nbytes = block_work(n, c, h, w, dtype, backward)
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


@lru_cache(maxsize=None)
def _forward_flops(reference: ModuleType, network_g: str,
                   shape: Tuple[int, ...]) -> float:
    net = json.loads(network_g)
    params = {k: torch.empty(s, device="meta")
              for k, s in reference.param_shapes(net).items()}
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        reference.forward(torch.empty(shape, device="meta"), params, net)
    return float(counter.get_total_flops())


def net_flops(shape: Sequence[int], net: dict,
              reference: ModuleType) -> float:
    """FLOPs (2 a multiply-add) of the plain forward of ``net``
    (``network_g``) on ``shape``, counted by ``FlopCounterMode`` over the
    configuration's ``reference`` on meta tensors."""
    return _forward_flops(reference, json.dumps(net, sort_keys=True),
                          tuple(int(s) for s in shape))
