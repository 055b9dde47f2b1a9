"""Fused ReLU + 2x2 / stride-2 max pool on NCHW: kernels K7/K8
(``csrc/pool.cu``) and their plain PyTorch versions.

Counterpart of ``lowlight_image_enhancement_tpu/ops/pallas/pool.py``
(torch ``MaxPool2d(2)`` after ``ReLU`` semantics):

- forward (K7, :func:`call_relu_pool_fwd`): ``y = maxpool2x2(relu(x))``,
  equal to ``relu(maxpool2x2(x))`` by monotonicity;
- backward (K8, :func:`call_pool_bwd`): the gradient goes to the first
  window position, in the order (0,0), (0,1), (1,0), (1,1), that equals
  the window max (compared in fp32; ``-0.0 == +0.0``); position (1,1)
  takes the remainder, so a window whose max is NaN still routes its
  gradient; with ``relu=True`` the window is taken of ``relu(x)`` and the
  result is masked by ``x > 0``.

An odd trailing row or column of ``x`` belongs to no window (the output
is ``[N, C, H // 2, W // 2]``) and gets a zero gradient. The kernels take
every shape. K7's vector widths, block and grid are chosen here
(:func:`pool_fwd_geometry`) and only checked by the kernel.

:func:`relu_max_pool_2x2` joins K7 and K8 (``relu=True``) under autograd;
:func:`max_pool_2x2_bwd` is K8 with ``relu=False``, the backward of a
plain max pool (``ops/image_ops.py:max_pool_2x2`` with
``impl="kernel_bwd"``).

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from lowlight_image_enhancement_tpu_torch.ops import _build
from lowlight_image_enhancement_tpu_torch.ops.layernorm import SM_COUNT

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _windows(t: torch.Tensor):
    """The four window positions of ``[N, C, H, W]`` (views; the odd
    trailing row / column left out), in the order (0,0), (0,1), (1,0),
    (1,1)."""
    h2, w2 = 2 * (t.shape[2] // 2), 2 * (t.shape[3] // 2)
    return (t[:, :, 0:h2:2, 0:w2:2], t[:, :, 0:h2:2, 1:w2:2],
            t[:, :, 1:h2:2, 0:w2:2], t[:, :, 1:h2:2, 1:w2:2])


def _window_max(r00, r01, r10, r11):
    # torch.maximum hands a NaN on, as jnp.maximum does
    return torch.maximum(torch.maximum(r00, r01), torch.maximum(r10, r11))


def plain_relu_pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """Plain K7: ``maxpool2x2(relu(x))`` on ``[N, C, H, W]``."""
    r = torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))
    return _window_max(*_windows(r)).contiguous()


def plain_pool_bwd(x: torch.Tensor, dy: torch.Tensor,
                   relu: bool = True) -> torch.Tensor:
    """Plain K8: ``dx`` like ``x`` from ``dy: [N, C, H // 2, W // 2]``."""
    v = x.float()
    r = torch.maximum(v, torch.zeros((), device=x.device)) if relu else v
    r00, r01, r10, r11 = _windows(r)
    m = _window_max(r00, r01, r10, r11)
    p00 = r00 == m
    p01 = (r01 == m) & ~p00
    p10 = (r10 == m) & ~p00 & ~p01
    p11 = ~p00 & ~p01 & ~p10          # the remainder, not "r11 == m"
    zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
    dx = torch.zeros_like(x)
    for pos, out in zip((p00, p01, p10, p11), _windows(dx)):
        out.copy_(torch.where(pos, dy, zero))
    if relu:
        dx = torch.where(v > 0, dx, zero)
    return dx


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what} must be [N, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the pool kernels take fp32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"the pool kernels need a contiguous {what}")
    if max(x.shape[2], x.shape[3]) >= 2 ** 31:
        raise ValueError(f"{what} is too large: {tuple(x.shape)}")


# K7's geometry (csrc/pool.cu:relu_pool_fwd_kernel). A thread makes Q = 16
# bytes of consecutive outputs of one output row (8 bf16 or 4 fp32 values,
# a "group") from 2Q elements of each of the two input rows of its windows.
# It loads them in vectors of lv elements and stores in vectors of sv:
#   lv = Q (16 bytes) where W % Q == 0 and x is 16-byte aligned, with
#        sv = Q where Wo % Q == 0, else Q / 2 (8 bytes);
#   lv = 2 where W is even (and x aligned to 2 elements), sv = 2 where Wo
#        is even, else 1;
#   lv = sv = 1 else (W odd).
# A block is bx groups of a row by by rows (bx * by <= 256; a row of more
# than 256 groups is cut into gy chunks of bx groups); gx blocks take the
# rows in strides of gx * by: one row a thread up to two rounds of blocks
# over the card, the rows beyond walked by addition.
POOL_FWD_THREADS = 256
POOL_FWD_ROUNDS = 2


class PoolFwdGeometry(NamedTuple):
    lv: int   # elements a load moves
    sv: int   # elements a store moves
    bx: int   # threads of a block along a row: groups
    by: int   # ... across rows
    gx: int   # blocks over the rows
    gy: int   # blocks along a row


def pool_fwd_geometry(dtype: torch.dtype, nc: int, h: int, w: int,
                      per_sm: int, offset: int = 0) -> PoolFwdGeometry:
    """K7's vector widths, block and grid on ``[NC, H, W]`` of ``dtype``
    whose data starts ``offset`` bytes past a 16-byte boundary, with
    ``per_sm`` blocks an SM (the built kernel's count on CUDA)."""
    es = 2 if dtype == torch.bfloat16 else 4
    q = 16 // es
    wo = w // 2
    fits = lambda lv: w % lv == 0 and offset % (lv * es) == 0
    if fits(q):
        lv, sv = q, (q if wo % q == 0 else q // 2)
    elif fits(2):
        lv, sv = 2, (2 if wo % 2 == 0 else 1)
    else:
        lv = sv = 1
    groups = max(1, -(-wo // q))
    gy = -(-groups // POOL_FWD_THREADS)
    bx = -(-groups // gy)
    by = POOL_FWD_THREADS // bx
    rows = max(1, nc * (h // 2))
    gx = max(1, min(-(-rows // by),
                    -(-POOL_FWD_ROUNDS * SM_COUNT * per_sm // gy)))
    return PoolFwdGeometry(lv, sv, bx, by, gx, gy)


def pool_fwd_blocks_per_sm(dtype: torch.dtype, lv: int, sv: int,
                           threads: int) -> int:
    """Blocks of the built K7 with ``(lv, sv)`` and ``threads`` threads a
    block that share an SM, as the CUDA runtime counts them (once per
    argument tuple)."""
    key = (dtype == torch.bfloat16, lv, sv, threads)
    if key not in _POOL_PER_SM:
        per_sm = _build.load("pool").relu_pool_fwd_blocks_per_sm(
            int(key[0]), lv, sv, threads)
        if per_sm < 1:
            raise RuntimeError(f"K7 {key}: no block fits on an SM ({per_sm})")
        _POOL_PER_SM[key] = per_sm
    return _POOL_PER_SM[key]


_POOL_PER_SM: Dict[Tuple[bool, int, int, int], int] = {}


def pool_fwd_geometry_for(x: torch.Tensor) -> PoolFwdGeometry:
    """K7's geometry on the CUDA tensor ``x: [N, C, H, W]``: blocks per SM
    from the built kernel at the block size the geometry chooses."""
    n, c, h, w = x.shape
    offset = x.data_ptr() % 16
    first = pool_fwd_geometry(x.dtype, n * c, h, w, 1, offset)
    per_sm = pool_fwd_blocks_per_sm(x.dtype, first.lv, first.sv,
                                    first.bx * first.by)
    return pool_fwd_geometry(x.dtype, n * c, h, w, per_sm, offset)


def call_relu_pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """K7 on ``x: [N, C, H, W]`` -> ``[N, C, H // 2, W // 2]``; plain
    version on CPU. On CUDA the geometry is :func:`pool_fwd_geometry_for`."""
    if not x.is_cuda:
        return plain_relu_pool_fwd(x)
    _check_cuda(x, "x")
    n, c, h, w = x.shape
    y = torch.empty((n, c, h // 2, w // 2), device=x.device, dtype=x.dtype)
    if y.numel() == 0:
        return y
    geo = pool_fwd_geometry_for(x)
    lib = _build.load("pool")
    with torch.cuda.device(x.device):
        rc = lib.relu_pool_fwd(x.data_ptr(), y.data_ptr(), n * c, h, w,
                               int(x.dtype == torch.bfloat16), *geo,
                               _build.current_stream(x))
    if rc != 0:
        raise RuntimeError(f"relu_pool_fwd launch failed: CUDA error {rc}")
    call_relu_pool_fwd.launches += 1
    return y


call_relu_pool_fwd.launches = 0


def call_pool_bwd(x: torch.Tensor, dy: torch.Tensor,
                  relu: bool = True) -> torch.Tensor:
    """K8 on ``x: [N, C, H, W]`` and ``dy: [N, C, H // 2, W // 2]`` ->
    ``dx`` like ``x``; plain version on CPU."""
    if not x.is_cuda:
        return plain_pool_bwd(x, dy, relu)
    _check_cuda(x, "x")
    _check_cuda(dy, "dy")
    n, c, h, w = x.shape
    if (dy.shape != (n, c, h // 2, w // 2) or dy.dtype != x.dtype
            or dy.device != x.device):
        raise ValueError(
            f"dy must be {(n, c, h // 2, w // 2)} {x.dtype} on {x.device}, "
            f"got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    dx = torch.empty_like(x)
    lib = _build.load("pool")
    with torch.cuda.device(x.device):
        rc = lib.pool_bwd(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n * c,
                          h, w, int(bool(relu)),
                          int(x.dtype == torch.bfloat16),
                          _build.current_stream(x))
    if rc != 0:
        raise RuntimeError(f"pool_bwd launch failed: CUDA error {rc}")
    call_pool_bwd.launches += 1
    return dx


call_pool_bwd.launches = 0


class _ReluMaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        ctx.save_for_backward(x)
        return call_relu_pool_fwd(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return call_pool_bwd(x, dy.contiguous(), relu=True)


def relu_max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``maxpool2x2(relu(x))`` fused, NCHW: K7 forward, K8 backward (the
    counterpart of the JAX ``relu_max_pool_2x2`` custom VJP)."""
    return _ReluMaxPool2x2.apply(x)


def max_pool_2x2_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Backward of a plain 2x2 max pool: K8 without the relu."""
    return call_pool_bwd(x, dy, relu=False)
