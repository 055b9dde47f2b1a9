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
every shape.

:func:`relu_max_pool_2x2` joins K7 and K8 (``relu=True``) under autograd;
:func:`max_pool_2x2_bwd` is K8 with ``relu=False``, the backward of a
plain max pool (``ops/image_ops.py:max_pool_2x2`` with
``impl="kernel_bwd"``).

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from lowlight_image_enhancement_tpu_torch.ops import _build

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


def call_relu_pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """K7 on ``x: [N, C, H, W]`` -> ``[N, C, H // 2, W // 2]``; plain
    version on CPU."""
    if not x.is_cuda:
        return plain_relu_pool_fwd(x)
    _check_cuda(x, "x")
    n, c, h, w = x.shape
    y = torch.empty((n, c, h // 2, w // 2), device=x.device, dtype=x.dtype)
    lib = _build.load("pool")
    with torch.cuda.device(x.device):
        rc = lib.relu_pool_fwd(x.data_ptr(), y.data_ptr(), n * c, h, w,
                               int(x.dtype == torch.bfloat16),
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
