"""Fused NAFBlock forward: kernels K1/K2 (``csrc/nafblock_fwd.cu``) and
their plain PyTorch versions.

Counterpart of ``lowlight_image_enhancement_tpu/ops/pallas/nafblock.py``
(forward only). Activations use the JAX kernels' layout ``[N, C, H*W]``,
which is contiguous NCHW viewed flat. One block forward is

- K1 (:func:`call_a`): LN1 -> conv1 1x1 C->2C -> depthwise 3x3 (zero SAME
  padding of the conv1 output) -> SimpleGate, plus the per-(n, c) spatial
  sums of the gate for the SCA mean;
- the tiny ``[N, C]`` SCA 1x1 (:func:`sca_attention`), plain torch as in
  the JAX ``_fwd_impl``;
- K2 (:func:`call_b`): gate * attention -> conv3 -> ``z = x + beta * .``
  -> LN2 -> conv4 C->2C -> gate -> conv5 -> ``z + gamma * .``.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``.launches``.

Numerics (as the TPU kernels): LN statistics and elementwise math in fp32,
matrix-product operands rounded to the compute dtype (bf16 when the
activations are bf16) with fp32 accumulation; the SCA mean is taken over
the whole ``H*W`` of the (padded) image.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from lowlight_image_enhancement_tpu_torch.ops import _build

Params = Dict[str, torch.Tensor]

_MATRICES = ("W1", "W3", "W4", "W5")


def pack_params(norm1_w, norm1_b, conv1_w, conv1_b, conv2_w, conv2_b,
                sca_w, sca_b, conv3_w, conv3_b, norm2_w, norm2_b,
                conv4_w, conv4_b, conv5_w, conv5_b, beta, gamma) -> Params:
    """Kernel-ready views of torch-layout NAFBlock parameters (no copies).

    1x1 conv weights ``[Cout, Cin, 1, 1]`` become ``[Cout, Cin]``; the
    depthwise ``[2C, 1, 3, 3]`` becomes ``[2C, 9]`` in tap order
    ``kh*3+kw``; vectors (and ``beta``/``gamma`` ``[1, C, 1, 1]``) become
    ``[C]``."""
    mat = lambda w: w.view(w.shape[0], w.shape[1])
    vec = lambda v: v.view(-1)
    return {
        "w1n": vec(norm1_w), "b1n": vec(norm1_b),
        "W1": mat(conv1_w), "b1": vec(conv1_b),
        "kdw": conv2_w.view(conv2_w.shape[0], 9), "bk": vec(conv2_b),
        "Wsca": mat(sca_w), "bsca": vec(sca_b),
        "W3": mat(conv3_w), "b3": vec(conv3_b),
        "w2n": vec(norm2_w), "b2n": vec(norm2_b),
        "W4": mat(conv4_w), "b4": vec(conv4_b),
        "W5": mat(conv5_w), "b5": vec(conv5_b),
        "beta": vec(beta), "gamma": vec(gamma),
    }


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ln(xf: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    """Channel LN over axis 1 of fp32 ``[N, C, S]``."""
    mu = xf.mean(1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * w.float()[:, None] + b.float()[:, None]


def _mm(w: torch.Tensor, a: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``w [O, I] @ a [N, I, S]`` with operands rounded to ``cdt`` and fp32
    accumulation (bf16 x bf16 products are exact in fp32)."""
    return torch.matmul(w.to(cdt).float(), a.to(cdt).float())


def plain_a(x: torch.Tensor, p: Params, hw: Tuple[int, int],
            eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: ``(g [N, C, S] in x.dtype, sums [N, C] fp32)``."""
    n, c, s = x.shape
    h, w = hw
    cdt = _compute_dtype(x)
    hn = _ln(x.float(), p["w1n"], p["b1n"], eps)
    t = _mm(p["W1"], hn, cdt) + p["b1"].float()[:, None]
    dw = t.shape[1]
    u = F.conv2d(t.view(n, dw, h, w), p["kdw"].float().view(dw, 1, 3, 3),
                 p["bk"].float(), padding=1, groups=dw)
    g = (u[:, :c] * u[:, c:]).reshape(n, c, s)
    return g.to(x.dtype), g.sum(2)


def sca_attention(sums: torch.Tensor, p: Params, area: int) -> torch.Tensor:
    """SCA between the kernels: ``mean @ Wsca.T + bsca`` on ``[N, C]``."""
    m = sums / float(area)
    return m @ p["Wsca"].float().t() + p["bsca"].float()


def plain_b(x: torch.Tensor, g: torch.Tensor, att: torch.Tensor, p: Params,
            eps: float = 1e-6) -> torch.Tensor:
    """Plain K2: the block output ``[N, C, S]`` in x.dtype."""
    cdt = _compute_dtype(x)
    v = g.float() * att.float()[:, :, None]
    pth = _mm(p["W3"], v, cdt) + p["b3"].float()[:, None]
    z = x.float() + p["beta"].float()[:, None] * pth
    h2 = _ln(z, p["w2n"], p["b2n"], eps)
    q = _mm(p["W4"], h2, cdt) + p["b4"].float()[:, None]
    f = q.shape[1] // 2
    sv = _mm(p["W5"], q[:, :f] * q[:, f:], cdt) + p["b5"].float()[:, None]
    return (z + p["gamma"].float()[:, None] * sv).to(x.dtype)


def nafblock_fwd_reference(x: torch.Tensor, p: Params, hw: Tuple[int, int],
                           eps: float = 1e-6) -> torch.Tensor:
    """The whole block in plain torch on ``x: [N, C, H*W]``."""
    g, sums = plain_a(x, p, hw, eps)
    att = sca_attention(sums, p, hw[0] * hw[1])
    return plain_b(x, g, att, p, eps)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(x: torch.Tensor, p: Params, names) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"NAFBlock kernels take fp32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("NAFBlock kernels need a contiguous [N, C, H*W] input")
    if x.shape[1] % 4:
        raise ValueError(f"NAFBlock kernels need C % 4 == 0, got C={x.shape[1]}")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p[k].requires_grad for k in names)):
        raise RuntimeError(
            "the NAFBlock kernels are forward-only: run under "
            "torch.no_grad() (the backward kernels are not ported yet)")
    for k in names:
        if p[k].device != x.device:
            raise ValueError(f"parameter {k} is on {p[k].device}, "
                             f"input on {x.device}")


def _kernel_args(p: Params, names, cdt: torch.dtype) -> list:
    """fp32 contiguous parameters, matrices rounded to ``cdt``; kept alive
    by the caller until the launch is enqueued."""
    out = []
    for k in names:
        t = p[k].detach()
        if k in _MATRICES:
            t = t.to(cdt)
        t = t.float().contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# K2's pixels per block (kPix in csrc/nafblock_fwd.cu) and the dynamic
# shared memory a Hopper block may use beside K2's 1 KB of static smem
_K2_PIXELS = 32
_K2_SMEM_BYTES = 232448 - 1024

_A_PARAMS = ("w1n", "b1n", "W1", "b1", "kdw", "bk")
_B_PARAMS = ("W3", "b3", "w2n", "b2n", "W4", "b4", "W5", "b5", "beta",
             "gamma")


def call_a(x: torch.Tensor, p: Params, hw: Tuple[int, int],
           eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on ``x: [N, C, H*W]`` -> ``(g, sums)``; plain version on CPU."""
    if not x.is_cuda:
        return plain_a(x, p, hw, eps)
    n, c, s = x.shape
    h, w = hw
    if h * w != s:
        raise ValueError(f"hw={hw} does not match H*W={s}")
    if p["W1"].shape != (2 * c, c):
        raise ValueError(
            f"K1 needs dw_expand == 2 (W1 [2C, C]); got W1 {tuple(p['W1'].shape)}")
    _check_cuda(x, p, _A_PARAMS)
    lib = _build.load()
    args = _kernel_args(p, _A_PARAMS, _compute_dtype(x))
    g = torch.empty_like(x)
    part = torch.empty((n, lib.nafblk_a_tiles(h, w), c), device=x.device,
                       dtype=torch.float32)
    sums = torch.empty((n, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = lib.nafblk_a(x.data_ptr(), *[t.data_ptr() for t in args],
                          g.data_ptr(), part.data_ptr(), sums.data_ptr(),
                          n, c, h, w, float(eps),
                          int(x.dtype == torch.bfloat16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"nafblk_a launch failed: CUDA error {rc}")
    call_a.launches += 1
    return g, sums


call_a.launches = 0


def call_b(x: torch.Tensor, g: torch.Tensor, att: torch.Tensor, p: Params,
           eps: float = 1e-6) -> torch.Tensor:
    """K2 on ``x, g: [N, C, H*W]``, ``att: [N, C]``; plain version on CPU."""
    if not x.is_cuda:
        return plain_b(x, g, att, p, eps)
    n, c, s = x.shape
    f = p["W5"].shape[1]
    if (g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous()
            or g.device != x.device):
        raise ValueError("K2 needs g like x (shape, dtype, device, contiguous)")
    if p["W4"].shape != (2 * f, c) or f % 4:
        raise ValueError(f"K2 needs W4 [2F, C] with F % 4 == 0; got "
                         f"W4 {tuple(p['W4'].shape)}")
    if (2 * c + f) * _K2_PIXELS * 4 > _K2_SMEM_BYTES:
        raise ValueError(
            f"K2 keeps (2C+F) x {_K2_PIXELS} fp32 values in shared memory: "
            f"C={c}, F={f} needs {(2 * c + f) * _K2_PIXELS * 4} bytes, more "
            f"than the {_K2_SMEM_BYTES} a block can use")
    _check_cuda(x, p, _B_PARAMS)
    lib = _build.load()
    args = _kernel_args(p, _B_PARAMS, _compute_dtype(x))
    att = att.detach().float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.nafblk_b(x.data_ptr(), g.data_ptr(), att.data_ptr(),
                          *[t.data_ptr() for t in args], out.data_ptr(),
                          n, c, f, s, float(eps),
                          int(x.dtype == torch.bfloat16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"nafblk_b launch failed: CUDA error {rc}")
    call_b.launches += 1
    return out


call_b.launches = 0


def nafblock_fwd(x: torch.Tensor, p: Params, hw: Tuple[int, int],
                 eps: float = 1e-6) -> torch.Tensor:
    """One NAFBlock forward on ``x: [N, C, H*W]``: K1 -> SCA -> K2 (the
    plain versions on CPU)."""
    g, sums = call_a(x, p, hw, eps)
    att = sca_attention(sums, p, hw[0] * hw[1])
    return call_b(x, g, att, p, eps)


def reset_launch_counts() -> None:
    call_a.launches = 0
    call_b.launches = 0
