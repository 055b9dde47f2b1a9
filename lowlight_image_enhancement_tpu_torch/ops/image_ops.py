"""Image operations.

Counterpart of ``lowlight_image_enhancement_tpu/ops/image_ops.py``:
``max_pool_2x2`` and ``pixel_unshuffle`` on NCHW (the pools of the VGG19
trunk and of ``UNetSID``'s downs; NAFNetTPU's space-to-depth);
:func:`resize_bilinear`, the port's one counterpart of every
``jax.image.resize(..., "bilinear")`` of the JAX metrics and models
(``UNetSID``'s upsampling among them); and, on NHWC as in JAX, the flow
warps :func:`flow_warp`, :func:`resize_flow` and the fps loop
:func:`measure_inference_speed`. Flow fields are ``[N, H, W, 2]`` in
(dx, dy) pixel units.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence, Tuple

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


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              interp_mode: str = "bilinear",
              padding_mode: str = "zeros") -> torch.Tensor:
    """Backward-warp NHWC ``x`` by ``flow``: ``out[n, i, j] = x[n, i +
    flow[n, i, j, 1], j + flow[n, i, j, 0]]``, bilinear (four taps
    gathered, weighted as JAX weighs them) or nearest (round half to even,
    as ``jnp.round``); samples outside the image are 0 (``zeros``) or the
    clamped edge (``border``). Unlike ``F.grid_sample``, no coordinate is
    normalised to [-1, 1] and back."""
    if interp_mode not in {"bilinear", "nearest"}:
        raise ValueError("interp_mode must be bilinear|nearest")
    if padding_mode not in {"zeros", "border"}:
        raise ValueError("padding_mode must be zeros|border")
    n, h, w, _ = x.shape
    if tuple(flow.shape) != (n, h, w, 2):
        raise ValueError(f"flow shape {tuple(flow.shape)} != {(n, h, w, 2)}")
    gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    sy = gy + flow[..., 1]
    sx = gx + flow[..., 0]
    batch = torch.arange(n, device=x.device)[:, None, None]

    def gather(iy, ix):
        vals = x[batch, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            vals = vals * valid[..., None].to(x.dtype)
        return vals

    if interp_mode == "nearest":
        return gather(torch.round(sy).long(), torch.round(sx).long())
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1 - wx) + gather(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def resize_flow(flow: torch.Tensor, size_type: str,
                sizes: Tuple[float, float],
                interp_mode: str = "bilinear") -> torch.Tensor:
    """Resize an NHWC flow field and rescale its displacements.
    ``size_type='ratio'``: ``sizes`` are (ratio_h, ratio_w); ``'shape'``:
    the target (H, W). Bilinear is :func:`resize_bilinear` (antialiased
    where it shrinks, as ``jax.image.resize``); nearest takes the source
    pixel under each output centre."""
    n, h, w, _ = flow.shape
    if size_type == "ratio":
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == "shape":
        out_h, out_w = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError("size_type must be ratio|shape")
    nchw = flow.permute(0, 3, 1, 2)
    if interp_mode == "bilinear":
        resized = resize_bilinear(nchw, (out_h, out_w))
    elif interp_mode == "nearest":
        resized = F.interpolate(nchw, size=(out_h, out_w),
                                mode="nearest-exact")
    else:
        raise ValueError("interp_mode must be bilinear|nearest")
    scale = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype,
                         device=flow.device)
    return resized.permute(0, 2, 3, 1) * scale


def _fence(out) -> None:
    """Wait for the device work behind ``out`` (a tensor, or a tuple or
    list of them) to finish."""
    tensors = out if isinstance(out, (tuple, list)) else (out,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def measure_inference_speed(fn: Callable, *args, max_iter: int = 100,
                            log_interval: int = 50) -> float:
    """fps loop (reference ``measure_inference_speed``,
    ``arch_util.py:313-350``): perf-counter timing, the first half taken as
    warm-up, fenced by ``torch.cuda.synchronize()`` where ``fn`` returns
    CUDA tensors. Returns calls per second."""
    num_warmup = max_iter // 2
    start = None
    out = None
    for i in range(max_iter):
        if i == num_warmup:
            _fence(out)
            start = time.perf_counter()
        out = fn(*args)
    _fence(out)
    return (max_iter - num_warmup) / (time.perf_counter() - start)
