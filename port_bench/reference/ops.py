"""Operations that the plain references share (NCHW, fp32).

``quant`` (optional, everywhere) rounds every tensor a network stores
between its operations: the lower-precision control of ``port_bench``
passes ``fp8_round``, the precision below the bf16 in which the program
keeps its activations. A reference module takes it as ``forward``'s
``quant`` and applies it with ``keep`` and ``conv``, so that every
configuration's control is the same rounding.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def keep(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    """``x`` as it is stored between operations: rounded by ``quant``."""
    return x if quant is None else quant(x)


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
         quant: Quant = None, **kw) -> torch.Tensor:
    if quant is not None:
        x, w = quant(x), quant(w)
    return keep(F.conv2d(x, w, b, **kw), quant)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the channels of NCHW ``x``."""
    mu = x.mean(1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * w.view(1, -1, 1, 1) \
        + b.view(1, -1, 1, 1)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (amax to
    448), returned in ``x``'s dtype; the gradient passes straight
    through."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / 448.0
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()
