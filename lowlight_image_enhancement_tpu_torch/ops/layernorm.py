"""Per-pixel channel LayerNorm ("LayerNorm2d") on NCHW: kernels K5/K6
(``csrc/layernorm.cu``) and their plain PyTorch versions.

Counterpart of ``lowlight_image_enhancement_tpu/ops/layernorm.py`` and
``ops/pallas/layernorm.py``: normalisation over the channel axis at every
spatial location, statistics in fp32 (mean, then the centred variance),
affine weight/bias per channel, result in the input's dtype.

- :func:`layer_norm_2d` is the eager forward under autograd, the reference
  the fused NAFBlock kernels are held against (``NAFBlock.forward_eager``).
- :func:`call_ln_fwd` (K5) and :func:`call_ln_bwd` (K6) work on the flat
  view ``[N, C, H*W]``, with the pixel tile and grid chosen here
  (:func:`ln_fwd_tile`; :func:`ln_bwd_tile`, :func:`ln_bwd_grid`);
  :class:`LayerNorm2dFunction` joins them under
  autograd, saving ``(xhat, rstd, weight)`` with ``xhat`` in fp32 as the
  TPU kernels do (the JAX jnp version rounds ``xhat`` to the activation
  dtype, so in bf16 its backward differs from this one).
- :func:`layer_norm_2d_auto` is what :class:`LayerNorm2d` runs.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``.launches``.

K5 is also the registered op ``llie_torch::ln_fwd`` (:func:`ln_fwd`: the
plain version on the CPU, :func:`call_ln_fwd` on CUDA, shapes only on fake
tensors), which :class:`LayerNorm2dFunction` calls, so ``torch.export``
keeps one node per LayerNorm. K6 is not registered: serving runs no
backward.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from lowlight_image_enhancement_tpu_torch.ops import _build

MAX_CHANNELS = 1024


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6, dim: int = 1) -> torch.Tensor:
    """LayerNorm over ``dim`` (the channel axis) with fp32 statistics."""
    xf = x.float()
    mu = xf.mean(dim, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    y = xc * torch.rsqrt(var + eps)
    y = y * weight.float().view(shape) + bias.float().view(shape)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def ln_stats(xf: torch.Tensor, eps: float):
    """``(xhat, rstd)`` of the channel LN over axis 1 of fp32 ``[N, C, S]``
    (the TPU kernels' ``_ln_fwd``); ``rstd`` is ``[N, 1, S]``."""
    mu = xf.mean(1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(1, keepdim=True) + eps)
    return xc * rstd, rstd


def ln_input_grad(dh: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Analytic channel-LN input grad (the TPU kernels' ``_ln_bwd``) from
    fp32 ``dh, xhat: [N, C, S]`` and ``rstd: [N, 1, S]``."""
    gxh = dh * w.float()[:, None]
    return (gxh - gxh.mean(1, keepdim=True)
            - xhat * (gxh * xhat).mean(1, keepdim=True)) * rstd


def plain_ln_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-6):
    """Plain K5 on ``x: [N, C, S]``: ``(y in x.dtype, xhat fp32 [N, C, S],
    rstd fp32 [N, S])``."""
    xhat, rstd = ln_stats(x.float(), eps)
    y = xhat * w.float()[:, None] + b.float()[:, None]
    return y.to(x.dtype), xhat, rstd[:, 0]


def plain_ln_bwd(g: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                 w: torch.Tensor):
    """Plain K6: ``(gx in g.dtype, gw fp32 [C], gb fp32 [C])`` from the
    output grad ``g: [N, C, S]`` and K5's residuals."""
    gf = g.float()
    gx = ln_input_grad(gf, xhat, rstd[:, None], w)
    return gx.to(g.dtype), (gf * xhat).sum((0, 2)), gf.sum((0, 2))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_activation(x: torch.Tensor, what: str) -> None:
    if x.dim() != 3:
        raise ValueError(f"{what} must be [N, C, H*W], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the LN kernels take fp32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"the LN kernels need a contiguous {what}")
    if x.numel() == 0:
        raise ValueError(f"the LN kernels take no empty {what}")
    if not 1 <= x.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"the LN kernels take 1 <= C <= {MAX_CHANNELS}, got "
                         f"C={x.shape[1]}")


def _vector(v: torch.Tensor, like: torch.Tensor, name: str) -> torch.Tensor:
    """``v`` as a contiguous fp32 ``[C]`` on ``like``'s device (``v`` itself
    when it is one already)."""
    if v.device != like.device:
        raise ValueError(f"{name} is on {v.device}, input on {like.device}")
    if v.numel() != like.shape[1]:
        raise ValueError(f"{name} has {v.numel()} entries for C="
                         f"{like.shape[1]}")
    if v.dtype == torch.float32 and v.is_contiguous():
        return v
    return v.detach().float().contiguous()


def _residual(t: torch.Tensor, shape, like: torch.Tensor, name: str) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != like.device):
        raise ValueError(f"{name} must be contiguous fp32 {tuple(shape)} on "
                         f"{like.device}")


# SMs of an H100; blocks K5 aims for: two for each
SM_COUNT = 132
LN_FWD_BLOCKS = 2 * SM_COUNT


def ln_fwd_tile(n: int, s: int) -> int:
    """Pixels per block of K5 on ``[N, C, S]``: the widest of 32, 16 and 8
    that still gives ``LN_FWD_BLOCKS`` blocks, else 8 (which gives at least
    ``N * S / 8`` blocks). A narrower tile reads shorter contiguous
    segments (``tile`` elements per channel)."""
    for px in (32, 16):
        if n * -(-s // px) >= LN_FWD_BLOCKS:
            return px
    return 8


def call_ln_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-6
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 on ``x: [N, C, H*W]`` -> ``(y, xhat, rstd)``; plain version on
    CPU."""
    if not x.is_cuda:
        return plain_ln_fwd(x, w, b, eps)
    _check_activation(x, "x")
    wf, bf = _vector(w, x, "weight"), _vector(b, x, "bias")
    n, c, s = x.shape
    y = torch.empty_like(x)
    xhat = torch.empty((n, c, s), device=x.device, dtype=torch.float32)
    rstd = torch.empty((n, s), device=x.device, dtype=torch.float32)
    lib = _build.load("layernorm")
    rc = _build.launch(x, lib.ln_fwd, x.data_ptr(), wf.data_ptr(),
                       bf.data_ptr(), y.data_ptr(), xhat.data_ptr(),
                       rstd.data_ptr(), n, c, s, float(eps),
                       int(x.dtype == torch.bfloat16), ln_fwd_tile(n, s))
    if rc != 0:
        raise RuntimeError(f"ln_fwd launch failed: CUDA error {rc}")
    call_ln_fwd.launches += 1
    return y, xhat, rstd


call_ln_fwd.launches = 0


# K6 (csrc/layernorm.cu:ln_bwd_kernel) keeps a thread's channels in
# registers: C over the 256 / tile thread groups, rounded up to 4, 8, 16 or
# 32 channels a thread. Up to this many channel-pixels a block (16 channels
# a thread) the tile may be wide; above it K6 takes 8 pixels.
LN_BWD_CHANNEL_PIXELS = 4096
# Blocks of K6 that share an SM, by channels a thread (its registers):
# chip_smoke.py holds the built kernel to at least these.
LN_BWD_BLOCKS_BY_CHANNELS = {4: 4, 8: 3, 16: 2, 32: 1}


def ln_bwd_channels(c: int, tile: int) -> int:
    """Channels a thread of K6 takes (the kernel's register arrays): ``C``
    over ``256 / tile`` groups, rounded up to 4, 8, 16 or 32; 0 above 32."""
    per = -(-c // (256 // tile))
    return next((k for k in (4, 8, 16, 32) if per <= k), 0)


def ln_bwd_tile(n: int, c: int, s: int) -> int:
    """Pixels per tile of K6 on ``[N, C, S]``: the widest of 32 and 16 that
    keeps ``C * tile`` within :data:`LN_BWD_CHANNEL_PIXELS` and still gives
    ``LN_FWD_BLOCKS`` tiles, else 8."""
    for px in (32, 16):
        if (c * px <= LN_BWD_CHANNEL_PIXELS
                and n * -(-s // px) >= LN_FWD_BLOCKS):
            return px
    return 8


def ln_bwd_blocks_per_sm(c: int, tile: int) -> int:
    """Blocks of K6 that share an SM (:data:`LN_BWD_BLOCKS_BY_CHANNELS`)."""
    return LN_BWD_BLOCKS_BY_CHANNELS[ln_bwd_channels(c, tile)]


def one_round(n: int, s: int, tile: int, per_sm: int) -> int:
    """Blocks per image of a kernel whose blocks walk an image's tiles of
    ``tile`` pixels in strides: one round of ``per_sm`` blocks on each SM
    over the card, no more than there are tiles."""
    return max(1, min(SM_COUNT * per_sm // n, -(-s // tile)))


def ln_bwd_grid(n: int, c: int, s: int, tile: int) -> int:
    """Blocks per image of K6 (:func:`one_round`)."""
    return one_round(n, s, tile, ln_bwd_blocks_per_sm(c, tile))


def call_ln_bwd(g: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6 on ``g: [N, C, H*W]`` and K5's residuals -> ``(gx, gw, gb)``;
    plain version on CPU."""
    if not g.is_cuda:
        return plain_ln_bwd(g, xhat, rstd, w)
    _check_activation(g, "g")
    n, c, s = g.shape
    _residual(xhat, (n, c, s), g, "xhat")
    _residual(rstd, (n, s), g, "rstd")
    wf = _vector(w, g, "weight")
    tile = ln_bwd_tile(n, c, s)
    grid = ln_bwd_grid(n, c, s, tile)
    gx = torch.empty_like(g)
    gwb = torch.empty((2, c), device=g.device, dtype=torch.float32)
    part = torch.empty((2, n * grid, c), device=g.device, dtype=torch.float32)
    lib = _build.load("layernorm")
    rc = _build.launch(g, lib.ln_bwd, g.data_ptr(), xhat.data_ptr(),
                       rstd.data_ptr(), wf.data_ptr(), gx.data_ptr(),
                       part.data_ptr(), gwb.data_ptr(), n, c, s,
                       int(g.dtype == torch.bfloat16), tile, grid)
    if rc != 0:
        raise RuntimeError(f"ln_bwd launch failed: CUDA error {rc}")
    call_ln_bwd.launches += 1
    return gx, gwb[0], gwb[1]


call_ln_bwd.launches = 0


@torch.library.custom_op("llie_torch::ln_fwd", mutates_args=(),
                         device_types="cpu")
def ln_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 on ``x: [N, C, H*W]`` -> ``(y like x, xhat fp32 like x, rstd fp32
    [N, H*W])``; this CPU kernel is the plain version."""
    return plain_ln_fwd(x, weight, bias, eps)


@ln_fwd.register_kernel("cuda")
def _ln_fwd_cuda(x, weight, bias, eps):
    return call_ln_fwd(x, weight, bias, eps)


@ln_fwd.register_fake
def _ln_fwd_fake(x, weight, bias, eps):
    n, c, s = x.shape
    return (torch.empty_like(x), x.new_empty((n, c, s), dtype=torch.float32),
            x.new_empty((n, s), dtype=torch.float32))


class LayerNorm2dFunction(torch.autograd.Function):
    """Channel LN on ``x: [N, C, ...]`` with K5 forward (the registered op
    :func:`ln_fwd`) and K6 backward
    (the counterpart of the JAX ``layer_norm_2d_pallas`` custom VJP).
    ``apply(x, weight, bias, eps)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        flat = x.contiguous().view(x.shape[0], x.shape[1], -1)
        y, xhat, rstd = ln_fwd(flat, weight, bias, eps)
        ctx.save_for_backward(xhat, rstd, weight)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        xhat, rstd, weight = ctx.saved_tensors
        gx, gw, gb = call_ln_bwd(g.contiguous().view(xhat.shape), xhat, rstd,
                                 weight)
        return gx.view(g.shape), gw.to(weight.dtype), gb.to(weight.dtype), None


def layer_norm_2d_auto(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Channel LN over axis 1 of ``[N, C, H, W]`` through
    :class:`LayerNorm2dFunction`: K5/K6 on a CUDA tensor (an input they do
    not take raises), their plain versions on a CPU tensor."""
    return LayerNorm2dFunction.apply(x, weight, bias, float(eps))


class LayerNorm2d(nn.Module):
    """Channel LayerNorm with learnable affine, on ``[N, C, H, W]``."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d_auto(x, self.weight, self.bias, self.eps)
