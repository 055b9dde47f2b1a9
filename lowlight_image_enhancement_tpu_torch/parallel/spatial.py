"""Spatial (height-sharded) parallelism for giant-image inference, NCHW.

Counterpart of ``lowlight_image_enhancement_tpu/parallel/spatial.py``:
ONE exact NAFNet forward with the image's height split over the ranks of
a process-group mesh (``parallel/mesh.py``), each rank holding its rows:

- every 3x3 conv takes one halo row from each neighbour; the halo is one
  ``all_gather`` of every rank's top and bottom boundary rows (few rows:
  it works on NCCL, and on gloo over CUDA and CPU tensors alike); the
  edge ranks take zeros, the zero padding of the single-device conv;
- the SCA global mean is one ``all_reduce`` of the local sums per block;
- 2x2 stride-2 downs and pixel-shuffle ups stay local (the padding keeps
  every shard's rows even through every scale);
- the LayerNorms run ``layer_norm_2d_auto``: K5 on the card (its
  backward K6), 2 per block;
- the collectives are ``torch.distributed.nn.functional``'s, which carry
  autograd: the forward is differentiable. Each rank's parameter
  gradients are its part of the gradient of the sum, over the ranks, of
  what each rank differentiates; a loss that every rank computes alike
  on the gathered output thus needs :func:`..mesh.all_reduce_mean_` of the
  gradients.

The fused NAFBlock kernels K1/K2 are not used here: K1 zero-pads its
depthwise input at its tile's edges and sums the SCA statistics over all
rows it is given, while a shard needs its neighbours' rows and its own
rows' sums. The JAX spatial path is unfused too.

Every rank returns the whole output (the rows gathered, cropped to the
input's size); peak activation memory per rank falls by about the number
of ranks.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from lowlight_image_enhancement_tpu_torch.models.nafnet import (
    NAFBlock,
    NAFNet,
    simple_gate,
)
from lowlight_image_enhancement_tpu_torch.ops.layernorm import (
    layer_norm_2d_auto,
)


def _world(mesh) -> int:
    return mesh.size if mesh is not None and mesh.distributed else 1


def _all_gather(x: torch.Tensor, mesh):
    import torch.distributed.nn.functional as dnn

    with warnings.catch_warnings():   # "deprecated" in newer releases
        warnings.simplefilter("ignore", FutureWarning)
        return dnn.all_gather(x.contiguous(), group=mesh.group)


def _all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed.nn.functional as dnn

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return dnn.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)


def halo_exchange_rows(x: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """Add ``halo`` boundary rows from each mesh neighbour to this rank's
    shard ``x: [N, C, Hs, W]`` -> ``[N, C, Hs + 2*halo, W]``. The first
    and last ranks receive zeros (the zero padding of a SAME conv at the
    image border); one rank pads."""
    n = _world(mesh)
    if n == 1:
        return F.pad(x, (0, 0, halo, halo))
    rows = _all_gather(torch.cat([x[:, :, :halo], x[:, :, -halo:]], dim=2),
                       mesh)
    r = mesh.index
    zeros = torch.zeros_like(x[:, :, :halo])
    top = rows[r - 1][:, :, halo:] if r > 0 else zeros
    bot = rows[r + 1][:, :, :halo] if r < n - 1 else zeros
    return torch.cat([top, x, bot], dim=2)


def _conv(x: torch.Tensor, m: torch.nn.Conv2d, col_pad: int = 0
          ) -> torch.Tensor:
    """``m`` in ``x``'s dtype with VALID rows and ``col_pad`` columns."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), b, stride=m.stride,
                    padding=(0, col_pad), groups=m.groups)


def _conv3x3(x: torch.Tensor, m: torch.nn.Conv2d, mesh) -> torch.Tensor:
    return _conv(halo_exchange_rows(x, 1, mesh), m, col_pad=1)


def _nafblock_sp(x: torch.Tensor, blk: NAFBlock, mesh) -> torch.Tensor:
    """One NAFBlock on a height shard: ``NAFBlock.forward_eager`` with the
    halo rows in its depthwise conv and the SCA mean over every rank."""
    dt = x.dtype
    y = layer_norm_2d_auto(x, blk.norm1.weight, blk.norm1.bias, blk.eps)
    y = _conv(y, blk.conv1)
    y = _conv3x3(y, blk.conv2, mesh)
    y = simple_gate(y)
    local = y.float().sum((2, 3), keepdim=True)
    total = _all_reduce(local, mesh) if _world(mesh) > 1 else local
    att = (total / (y.shape[2] * _world(mesh) * y.shape[3])).to(dt)
    y = y * _conv(att, blk.sca[1])
    y = _conv(y, blk.conv3)
    z = x + y * blk.beta.to(dt)
    y = layer_norm_2d_auto(z, blk.norm2.weight, blk.norm2.bias, blk.eps)
    y = simple_gate(_conv(y, blk.conv4))
    y = _conv(y, blk.conv5)
    return z + y * blk.gamma.to(dt)


def _shard_forward(net: NAFNet, inp: torch.Tensor, mesh) -> torch.Tensor:
    """The NAFNet forward of one height shard ``inp`` of the padded
    image."""
    inp = inp.to(net.dtype)
    x = _conv3x3(inp, net.intro, mesh)
    skips = []
    for enc, down in zip(net.encoders, net.downs):
        for blk in enc:
            x = _nafblock_sp(x, blk, mesh)
        skips.append(x)
        x = _conv(x, down)
    for blk in net.middle_blks:
        x = _nafblock_sp(x, blk, mesh)
    for dec, up, skip in zip(net.decoders, net.ups, skips[::-1]):
        x = F.pixel_shuffle(_conv(x, up[0]), 2) + skip
        for blk in dec:
            x = _nafblock_sp(x, blk, mesh)
    x = _conv3x3(x, net.ending, mesh) + inp
    return x.float()


def spatial_pad_multiple(net, n_shards: int) -> int:
    """The height must split into shards that stay even through every
    down: ``n_shards * 2**len(enc_blk_nums)``. The width needs the model's
    own ``padder_size``."""
    return n_shards * net.padder_size


def nafnet_apply_spatial(net: NAFNet, x: torch.Tensor, mesh: Optional[object]
                         ) -> torch.Tensor:
    """Exact NAFNet forward of ``x: [N, C, H, W]`` (the whole image, on
    this rank's device) with the height split over ``mesh``'s ranks; every
    rank returns the whole ``[N, C, H, W]`` fp32 output.

    For heights that ``spatial_pad_multiple(net, n)`` divides the result
    equals the single-device forward to float tolerance; other heights get
    more zero rows than the single-device pad, which moves the SCA means
    slightly (as JAX's)."""
    if not isinstance(net, NAFNet):
        raise ValueError(
            f"expected an unrolled NAFNet (intro, encoders, middle_blks, "
            f"decoders of NAFBlocks), got {type(net).__name__}")
    blocks = net.blocks()
    if any(b.dropout_rate for b in blocks):
        raise ValueError("spatial inference is deterministic-only")
    if any(b.tlc_window is not None for b in blocks):
        raise ValueError(
            "TLC local statistics are a single-device approximation; the "
            "spatial-parallel forward computes exact global SCA instead")
    n = _world(mesh)
    _, _, h, w = x.shape
    mh = spatial_pad_multiple(net, n)
    mw = net.padder_size
    hp = -(-h // mh) * mh
    wp = -(-w // mw) * mw
    x = F.pad(x, (0, wp - w, 0, hp - h))
    rows = hp // n
    r = mesh.index if n > 1 else 0
    out = _shard_forward(net, x[:, :, r * rows:(r + 1) * rows], mesh)
    if n > 1:
        out = torch.cat(_all_gather(out, mesh), dim=2)
    return out[:, :, :h, :w]
