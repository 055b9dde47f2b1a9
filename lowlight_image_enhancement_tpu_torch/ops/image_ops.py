"""Image operations (NCHW).

Counterpart of ``max_pool_2x2`` and ``pixel_unshuffle`` in
``lowlight_image_enhancement_tpu/ops/image_ops.py`` (the pools of the
VGG19 trunk and of ``UNetSID``'s downs; NAFNetTPU's space-to-depth), and
:func:`resize_bilinear`, the port's one counterpart of every
``jax.image.resize(..., "bilinear")`` of the JAX metrics and models
(``UNetSID``'s upsampling among them). The flow warps and the fps loop of
that file (``flow_warp``, ``resize_flow``, ``measure_inference_speed``,
``:146-247``) are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from lowlight_image_enhancement_tpu_torch.ops.pool import max_pool_2x2_bwd

# "pallas_bwd" is the JAX package's spelling of "kernel_bwd"
MAXPOOL_IMPLS = ("reduce_window", "kernel_bwd", "pallas_bwd")


class _MaxPoolKernelBwd(torch.autograd.Function):
    """Library forward, K8 (``relu=False``) backward: the counterpart of the
    JAX ``_pool_pallas_bwd`` custom VJP."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        ctx.save_for_backward(x)
        return F.max_pool2d(x, 2, 2)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return max_pool_2x2_bwd(x, dy.contiguous())


def _resolve_impl(impl: Optional[str]) -> str:
    """``impl``, or ``$LLIE_MAXPOOL_IMPL`` (default ``reduce_window``) when
    it is None; an unknown name raises."""
    if impl is None:
        impl = os.environ.get("LLIE_MAXPOOL_IMPL", "reduce_window")
    if impl not in MAXPOOL_IMPLS:
        raise ValueError(f"max-pool implementation must be one of "
                         f"{MAXPOOL_IMPLS}, got {impl!r}")
    return "kernel_bwd" if impl == "pallas_bwd" else impl


def max_pool_2x2(x: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """2x2 / stride-2 max pool of NCHW ``x``: an odd trailing row or column
    is floored away, and the gradient goes to the first maximum of each
    window in the order (0,0), (0,1), (1,0), (1,1) (torch ``MaxPool2d`` and
    XLA select-and-scatter semantics).

    ``impl`` selects the backward (``None`` reads ``$LLIE_MAXPOOL_IMPL``,
    as the JAX function does):

    - ``reduce_window`` (default): ``F.max_pool2d`` under autograd;
    - ``kernel_bwd`` (JAX spelling ``pallas_bwd``): the same forward, the
      backward through kernel K8 (``ops/pool.py:max_pool_2x2_bwd``). The
      kernel takes every shape, so unlike the JAX option it never steps
      back to the library."""
    if _resolve_impl(impl) == "kernel_bwd":
        return _MaxPoolKernelBwd.apply(x)
    return F.max_pool2d(x, 2, 2)


def pixel_unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NCHW pixel unshuffle with torch channel ordering ``(c, r1, r2)``."""
    n, c, h, w = x.shape
    if h % r or w % r:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {r}")
    x = x.reshape(n, c, h // r, r, w // r, r)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` = (H, W), half-pixel
    centres, antialiased where it shrinks an axis: the arithmetic of
    ``jax.image.resize(..., method="bilinear")``, whose triangle filter
    widens by the scale factor when it downsamples (without ``antialias``
    torch samples only the two nearest pixels there). Where no axis
    shrinks both torch paths compute the same filter, and the plain one
    rounds as JAX does (5e-7 against 1e-5 at 64x48 -> 299^2 on N(0, 1)
    data), so it takes that one."""
    size = tuple(int(s) for s in size)
    shrinks = any(d < s for d, s in zip(size, x.shape[-2:]))
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrinks)
