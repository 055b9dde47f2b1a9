"""Fused NAFBlock: kernels K1/K2 (``csrc/nafblock_fwd.cu``,
``csrc/nafblock_fwd_mma.cuh``), K3/K4 (``csrc/nafblock_bwd.cu``,
``csrc/nafblock_p1_mma.cuh``, ``csrc/nafblock_p2_mma.cuh``) and their plain
PyTorch versions.

Counterpart of ``lowlight_image_enhancement_tpu/ops/pallas/nafblock.py``.
Activations use the JAX kernels' layout ``[N, C, H*W]``, which is
contiguous NCHW viewed flat. One block forward is

- K1 (:func:`call_a`): LN1 -> conv1 1x1 C->2C -> depthwise 3x3 (zero SAME
  padding of the conv1 output) -> SimpleGate, plus the per-(n, c) spatial
  sums of the gate for the SCA mean;
- the tiny ``[N, C]`` SCA 1x1 (:func:`sca_attention`), plain torch as in
  the JAX ``_fwd_impl``;
- K2 (:func:`call_b`): gate * attention -> conv3 -> ``z = x + beta * .``
  -> LN2 -> conv4 C->2C -> gate -> conv5 -> ``z + gamma * .``.

and its backward (:class:`NAFBlockFunction`, the counterpart of the JAX
``fused_nafblock`` custom VJP):

- K3 (:func:`call_p1`): recomputes the second half from ``(x, g, att)``
  and returns ``dz``, the SCA grad ``da`` and the second-half weight grads;
- the ``[N, C]`` SCA backward (:func:`sca_backward`), plain torch as in
  the JAX ``_vjp_bwd``;
- K4 (:func:`call_p2`): recomputes LN1/conv1/depthwise from ``x`` and
  returns ``dx`` and the first-half weight grads.

Every kernel has three routes, chosen by dtype and shape, never on a
failure:

- bf16 with C (and F) a multiple of 16 runs on the tensor cores
  (``mma.sync``): K1 as ``k1_front_kernel`` + ``k1_dw_kernel`` with the
  tile and grids of :func:`k1_geometry`, K2 as ``k2_mma_kernel``
  (:func:`k2_geometry`), K3 as ``k3_mma_kernel`` (:func:`p1_geometry`), K4
  as its front, depthwise and back kernels (:func:`p2_geometry`);
- fp32 with C (and F) a multiple of 16 and a tile that fits runs on the
  tensor cores too, each product as three TF32 products ("3xTF32": one
  would break the 1e-4 tolerance): K1 as ``k1_front_tf32_kernel`` +
  ``k1_dw_kernel``, K2 as ``k2_tf32_kernel``, K3 as ``k3_tf32_kernel``,
  K4 as ``k4_front_tf32_kernel``, ``k4_dw_kernel``,
  ``k4_back_tf32_kernel`` with ``wgrad_tf32_kernel`` (the geometry
  functions' ``dtype=torch.float32`` forms);
- everything else runs the FMA kernels of the first port: C or F no
  multiple of 16 (or no tile that fits) in either dtype, all four kernels
  alike. They are
  instantiated for bf16 activations too, with every product operand
  rounded to bf16 as the tensor-core route rounds it. They read matrix
  rows as float4, so each matrix reaches them with its rows zero-padded
  to a multiple of 4 (:func:`padded_matrices`, once per block forward);
  the activations keep their true C and the weight grads their true
  shapes. A bf16 block whose forward runs on the card runs its backward
  there too. ``launch_a``, ``launch_b``, ``launch_p1`` and ``launch_p2``
  take the route as an argument, uncounted, so ``chip_smoke.py`` can time
  the FMA kernels beside the tensor-core ones on the same inputs.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``.launches``.

The forward kernels are also registered ``torch.library`` ops,
``llie_torch::nafblock_a`` (K1 -> ``(g, sums)``) and
``llie_torch::nafblock_b`` (K2 -> ``out``), each with a CPU kernel (the
plain version), a CUDA kernel (:func:`call_a`, :func:`call_b`), a fake
kernel that computes shapes only and a FLOP formula (what
``torch.utils.flop_counter`` counts of the plain version's products).
:class:`NAFBlockFunction` calls them, so
``torch.export`` keeps one node of each per block where it would otherwise
meet ctypes calls on ``data_ptr()`` that fake tensors cannot run.

Numerics (as the TPU kernels): LN statistics and elementwise math in fp32,
matrix-product operands rounded to the compute dtype (bf16 when the
activations are bf16) with fp32 accumulation, weight grads in fp32; the
SCA mean is taken over the whole ``H*W`` of the (padded) image. One
deliberate difference: the gate gradient uses ``u = dw3x3(t) + bk``, the
block's true derivative; the TPU kernel P2 leaves ``bk`` out (exact only
while ``bk == 0``, its initial value).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from lowlight_image_enhancement_tpu_torch.ops import _build
from lowlight_image_enhancement_tpu_torch.ops.layernorm import (
    SM_COUNT,
    one_round,
)
from lowlight_image_enhancement_tpu_torch.ops.layernorm import (
    ln_input_grad as _ln_bwd,
)
from lowlight_image_enhancement_tpu_torch.ops.layernorm import (
    ln_stats as _ln_stats,
)

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


def row_pitch(k: int) -> int:
    """Row length of a matrix on the FMA route: ``k`` rounded up to a
    multiple of 4 (``pitch4`` of ``csrc/nafblock_common.cuh``)."""
    return -(-k // 4) * 4


def padded_matrices(p: Params) -> Params:
    """``p`` with each matrix's rows zero-padded to :func:`row_pitch` of
    their length (W1, W3, W4 ``[., C]`` to ``pitch(C)``, W5 ``[C, F]`` to
    ``pitch(F)``), as the FMA kernels read them; ``p`` itself when every
    row already is. Padding a padded ``p`` changes nothing."""
    pads = {k: row_pitch(p[k].shape[1]) - p[k].shape[1]
            for k in _MATRICES if k in p}
    if not any(pads.values()):
        return p
    return {k: F.pad(t.detach(), (0, pads[k])) if pads.get(k) else t
            for k, t in p.items()}


def true_matrices(p: Params, c: int) -> Params:
    """The matrices of ``p`` at their true shapes (views): the columns of
    W1, W3, W4 past ``c`` and of W5 past ``F`` dropped, so the plain
    versions take ``p`` padded or not."""
    f = p["W4"].shape[0] // 2 if "W4" in p else None
    cols = {"W1": c, "W3": c, "W4": c, "W5": f}
    if all(p[k].shape[1] == cols[k] for k in _MATRICES if k in p):
        return p
    return {k: t[:, :cols[k]] if k in _MATRICES else t for k, t in p.items()}


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ln(xf: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    """Channel LN over axis 1 of fp32 ``[N, C, S]``."""
    return _ln_stats(xf, eps)[0] * w.float()[:, None] + b.float()[:, None]


def _mm(w: torch.Tensor, a: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``w [O, I] @ a [N, I, S]`` with operands rounded to ``cdt`` and fp32
    accumulation (bf16 x bf16 products are exact in fp32)."""
    return torch.matmul(w.to(cdt).float(), a.to(cdt).float())


def plain_a_front(x: torch.Tensor, p: Params,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain first stage of K1: ``t = W1 LN1(x) + b1``, fp32
    ``[N, 2C, S]`` (the operands of the product rounded to x's compute
    dtype)."""
    p = true_matrices(p, x.shape[1])
    hn = _ln(x.float(), p["w1n"], p["b1n"], eps)
    return _mm(p["W1"], hn, _compute_dtype(x)) + p["b1"].float()[:, None]


def plain_a_dw(t: torch.Tensor, p: Params, hw: Tuple[int, int],
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain second stage of K1 on the fp32 ``t [N, 2C, S]``: ``u =
    dw3x3(t) + bk`` (t zero outside the image), ``g = u1 * u2`` ->
    ``(g [N, C, S] in dtype, sums [N, C] fp32)``, the sums taken before g
    is rounded."""
    n, dw, s = t.shape
    h, w = hw
    u = F.conv2d(t.view(n, dw, h, w), p["kdw"].float().view(dw, 1, 3, 3),
                 p["bk"].float(), padding=1, groups=dw)
    g = (u[:, :dw // 2] * u[:, dw // 2:]).reshape(n, dw // 2, s)
    return g.to(dtype), g.sum(2)


def plain_a(x: torch.Tensor, p: Params, hw: Tuple[int, int],
            eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: ``(g [N, C, S] in x.dtype, sums [N, C] fp32)``, its two
    stages composed."""
    return plain_a_dw(plain_a_front(x, p, eps), p, hw, x.dtype)


def sca_attention(sums: torch.Tensor, p: Params, area: int) -> torch.Tensor:
    """SCA between the kernels: ``mean @ Wsca.T + bsca`` on ``[N, C]``."""
    m = sums / float(area)
    return m @ p["Wsca"].float().t() + p["bsca"].float()


def plain_b(x: torch.Tensor, g: torch.Tensor, att: torch.Tensor, p: Params,
            eps: float = 1e-6) -> torch.Tensor:
    """Plain K2: the block output ``[N, C, S]`` in x.dtype."""
    p = true_matrices(p, x.shape[1])
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


def _mm_t(w: torch.Tensor, a: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``w.T @ a`` for ``w [O, I]``, ``a [N, O, S]``, operands rounded to
    ``cdt``, fp32 accumulation."""
    return torch.matmul(w.to(cdt).float().t(), a.to(cdt).float())


def _outer(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Weight grad ``sum over n, s of a[n, :, s] b[n, :, s]^T`` with
    operands rounded to ``cdt`` (fp32 result)."""
    return torch.einsum("nis,njs->ij", a.to(cdt).float(), b.to(cdt).float())


def _sum(t: torch.Tensor) -> torch.Tensor:
    """Per-channel sum over batch and pixels of ``[N, C, S]``."""
    return t.sum((0, 2))


def plain_p1(x: torch.Tensor, g: torch.Tensor, dout: torch.Tensor,
             att: torch.Tensor, p: Params, eps: float = 1e-6):
    """Plain K3: ``(dz in dout.dtype, da [N, C] fp32, grads)`` with fp32
    grads of W3, b3, w2n, b2n, W4, b4, W5, b5, beta, gamma.

    Mirrors ``_kernel_p1``: the second half is recomputed from ``(x, g,
    att)``; every product rounds both operands to the compute dtype."""
    p = true_matrices(p, x.shape[1])
    cdt = _compute_dtype(x)
    f = p["W5"].shape[1]
    col = lambda k: p[k].float()[:, None]
    gf = g.float()
    v = gf * att.float()[:, :, None]
    pth = _mm(p["W3"], v, cdt) + col("b3")
    z = x.float() + col("beta") * pth
    xhat2, rstd2 = _ln_stats(z, eps)
    h2 = xhat2 * col("w2n") + col("b2n")
    q = _mm(p["W4"], h2, cdt) + col("b4")
    q1, q2 = q[:, :f], q[:, f:]
    wv = q1 * q2
    s = _mm(p["W5"], wv, cdt) + col("b5")

    do = dout.float()
    ds = col("gamma") * do
    dwv = _mm_t(p["W5"], ds, cdt)
    dq = torch.cat([dwv * q2, dwv * q1], 1)
    dh2 = _mm_t(p["W4"], dq, cdt)
    dz = do + _ln_bwd(dh2, xhat2, rstd2, p["w2n"])
    dp = col("beta") * dz
    dv = _mm_t(p["W3"], dp, cdt)
    grads = {
        "gamma": _sum(do * s), "W5": _outer(ds, wv, cdt), "b5": _sum(ds),
        "W4": _outer(dq, h2, cdt), "b4": _sum(dq),
        "w2n": _sum(dh2 * xhat2), "b2n": _sum(dh2),
        "beta": _sum(dz * pth), "W3": _outer(dp, v, cdt), "b3": _sum(dp),
    }
    return dz.to(dout.dtype), (dv * gf).sum(2), grads


def sca_backward(da: torch.Tensor, m: torch.Tensor, p: Params, area: int):
    """SCA backward between the kernels (the JAX ``_vjp_bwd`` glue):
    ``(dWsca [C, C], dbsca [C], dgc [N, C])`` from the attention grad
    ``da`` and the saved mean ``m`` (both ``[N, C]`` fp32)."""
    dgc = (da @ p["Wsca"].float()) / float(area)
    return da.t() @ m, da.sum(0), dgc


def plain_p2(x: torch.Tensor, dz: torch.Tensor, dgc: torch.Tensor,
             att: torch.Tensor, p: Params, hw: Tuple[int, int],
             eps: float = 1e-6):
    """Plain K4: ``(dx in dz.dtype, grads)`` with fp32 grads of w1n, b1n,
    W1, b1, kdw ``[2C, 9]`` and bk.

    Mirrors ``_kernel_p2`` on the whole image: LN1/conv1/depthwise are
    recomputed from ``x`` (conv1 output zero-padded), the gate grad is
    ``(W3^T (beta dz)) att + dgc``, and the depthwise adjoint and tap grads
    are convolutions with ``t`` and the flipped taps. ``u`` includes ``bk``
    (the true derivative; the TPU kernel leaves ``bk`` out)."""
    n, c, s = x.shape
    p = true_matrices(p, c)
    h, w = hw
    cdt = _compute_dtype(x)
    col = lambda k: p[k].float()[:, None]
    xhat, rstd = _ln_stats(x.float(), eps)
    hn = xhat * col("w1n") + col("b1n")
    t = _mm(p["W1"], hn, cdt) + col("b1")
    dwc = t.shape[1]
    t4 = t.view(n, dwc, h, w)
    k4 = p["kdw"].float().view(dwc, 1, 3, 3)
    u = F.conv2d(t4, k4, p["bk"].float(), padding=1, groups=dwc)

    dzf = dz.float()
    dv = _mm_t(p["W3"], col("beta") * dzf, cdt)
    dg = (dv * att.float()[:, :, None] + dgc.float()[:, :, None]).view(
        n, c, h, w)
    du = torch.cat([dg * u[:, c:], dg * u[:, :c]], 1)
    dt = F.conv2d(du, k4.flip(2, 3), padding=1, groups=dwc).reshape(n, dwc, s)
    tp = F.pad(t4, (1, 1, 1, 1))
    dk = torch.stack([(du * tp[:, :, kh:kh + h, kw:kw + w]).sum((0, 2, 3))
                      for kh in range(3) for kw in range(3)], 1)
    dh = _mm_t(p["W1"], dt, cdt)
    dx = _ln_bwd(dh, xhat, rstd, p["w1n"]) + dzf
    grads = {"W1": _outer(dt, hn, cdt), "b1": _sum(dt),
             "w1n": _sum(dh * xhat), "b1n": _sum(dh), "kdw": dk,
             "bk": du.sum((0, 2, 3))}
    return dx.to(dz.dtype), grads


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(x: torch.Tensor, p: Params, names) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"NAFBlock kernels take fp32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("NAFBlock kernels need a contiguous [N, C, H*W] input")
    for k in names:
        if p[k].device != x.device:
            raise ValueError(f"parameter {k} is on {p[k].device}, "
                             f"input on {x.device}")


def _kernel_args(p: Params, names, cdt: torch.dtype,
                 matrices: torch.dtype = torch.float32) -> list:
    """Contiguous, 16-byte aligned parameters, kept alive by the caller
    until the launch is enqueued: vectors fp32; matrices rounded to ``cdt``
    and handed over as ``matrices`` (fp32, or bf16 for a kernel that feeds
    them to the tensor cores as they are). A parameter that already is
    what the kernel takes is passed on untouched."""
    out = []
    for k in names:
        t = p[k]
        if k in _MATRICES and t.dtype != cdt:
            t = t.detach().to(cdt)
        want = matrices if k in _MATRICES else torch.float32
        if t.dtype != want:
            t = t.detach().to(want)
        if not t.is_contiguous():
            t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _like_x(x: torch.Tensor, **named) -> None:
    for name, t in named.items():
        if (t.shape != x.shape or t.dtype != x.dtype or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be like x (shape, dtype, device, "
                             "contiguous)")


_A_PARAMS = ("w1n", "b1n", "W1", "b1", "kdw", "bk")
_B_PARAMS = ("W3", "b3", "w2n", "b2n", "W4", "b4", "W5", "b5", "beta",
             "gamma")


# Geometry of K1 and K2 on the tensor cores (csrc/nafblock_fwd_mma.cuh in
# bf16, csrc/nafblock_fwd_tf32.cuh in fp32 as 3xTF32): the pixel tiles of
# K3 (32, 16 or 8 pixels, operand rows padded by 8 above 8 pixels); up to
# 64 channels the weights stay in shared memory (rows padded by 8), else
# bf16 passes them through the ring of three weight slabs and fp32 gives
# them no shared memory (each warp reads its rows from global memory).
#   K1 front: x fp32 [C][tile], h [C][rows], W1 [2C]
#   K2: v, h2, wv [max(C, F)][rows], W3 + W4 + W5, z fp32 [C][tile],
#   q fp32 [2F][tile]
# with h, v, h2, wv and the weights bf16 in bf16 and fp32 in fp32. Both
# have 1 KB of static shared memory. K1's depthwise kernel takes 2-D tiles
# of 32 x 32 pixels and one channel pair a block. chip_smoke.py holds
# k1_smem_bytes / k2_smem_bytes against the kernels' own sums.
FWD_RESIDENT_MAX = 64
FWD_STATIC_SMEM = 1024
# Blocks of the pixel-tile kernels that their registers allow on an SM, by
# (resident weights, tile), as the CUDA runtime counts them for the built
# kernels on an H100. On CUDA the wrappers ask the built kernels instead
# (built=True); these tables exist for the CPU tests of the geometry, which
# have no built kernel, and chip_smoke.py holds them against the runtime.
K1_BLOCKS_BY_REGISTERS = {(False, 32): 3, (False, 16): 4, (False, 8): 5,
                          (True, 32): 3, (True, 16): 5, (True, 8): 5}
K2_BLOCKS_BY_REGISTERS = {(False, 32): 3, (False, 16): 3, (False, 8): 3,
                          (True, 32): 3, (True, 16): 4, (True, 8): 5}
# the same for the fp32 kernels (k1_front_tf32_kernel, k2_tf32_kernel)
K1_TF32_BLOCKS_BY_REGISTERS = {(False, 32): 3, (False, 16): 4, (False, 8): 4,
                               (True, 32): 3, (True, 16): 4, (True, 8): 4}
K2_TF32_BLOCKS_BY_REGISTERS = {(False, 32): 2, (False, 16): 3, (False, 8): 3,
                               (True, 32): 3, (True, 16): 3, (True, 8): 3}
K1_DW_TILE = (32, 32)
# blocks of the depthwise kernel on an SM, g in bf16 or in fp32 alike
K1_DW_BLOCKS_PER_SM = 3


def k1_smem_bytes(c: int, tile: int,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of K1's front kernel on the tensor cores (bf16,
    or fp32 for 3xTF32) with ``tile`` pixels."""
    ldb = tile if tile == 8 else tile + 8
    resident = c <= FWD_RESIDENT_MAX
    if dtype == torch.float32:
        return (c * tile + c * ldb + (2 * c * (c + 8) if resident else 0)) * 4
    w = 2 * c * (c + 8) * 2 if resident else P1_SLAB_BYTES
    return c * tile * 4 + c * ldb * 2 + w


def k2_smem_bytes(c: int, f: int, tile: int,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of K2 on the tensor cores (bf16, or fp32 for
    3xTF32) with ``tile`` pixels."""
    ldb = tile if tile == 8 else tile + 8
    resident = c <= FWD_RESIDENT_MAX and f <= FWD_RESIDENT_MAX
    mats = (c + 2 * f) * (c + 8) + c * (f + 8)
    if dtype == torch.float32:
        return (max(c, f) * ldb + (mats if resident else 0)
                + (c + 2 * f) * tile) * 4
    w = mats * 2 if resident else P1_SLAB_BYTES
    return max(c, f) * ldb * 2 + w + (c + 2 * f) * tile * 4


def _built_per_sm(entry: str, *args: int) -> int:
    """Blocks per SM of a built kernel of ``csrc/nafblock_fwd.cu`` as the
    CUDA runtime counts them (entry point ``entry``), once per argument
    tuple."""
    if args not in _BUILT_PER_SM.setdefault(entry, {}):
        per_sm = getattr(_build.load("nafblock_fwd"), entry)(*args)
        if per_sm < 1:
            raise RuntimeError(f"{entry}{args}: no block fits on an SM "
                               f"({per_sm})")
        _BUILT_PER_SM[entry][args] = per_sm
    return _BUILT_PER_SM[entry][args]


_BUILT_PER_SM: Dict[str, Dict[tuple, int]] = {}


def _fwd_kind(dtype: torch.dtype) -> str:
    """The name part of the tensor-core kernels of ``dtype``: ``mma`` (bf16)
    or ``tf32`` (fp32)."""
    return "tf32" if dtype == torch.float32 else "mma"


def k1_blocks_per_sm(c: int, tile: int, built: bool = False,
                     dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of K1's front kernel on the tensor cores (bf16, or fp32 for
    3xTF32) that share an SM: as many as its registers and shared memory
    (dynamic, 1 KB static, 1 KB reserved) allow; with ``built``, as the
    runtime counts them for the built kernel."""
    if built:
        return _built_per_sm(f"nafblk_a_{_fwd_kind(dtype)}_blocks_per_sm", c,
                             tile)
    table = (K1_TF32_BLOCKS_BY_REGISTERS if dtype == torch.float32
             else K1_BLOCKS_BY_REGISTERS)
    return min(table[c <= FWD_RESIDENT_MAX, tile],
               SM_SMEM // (k1_smem_bytes(c, tile, dtype)
                           + FWD_STATIC_SMEM + 1024))


def k2_blocks_per_sm(c: int, f: int, tile: int, built: bool = False,
                     dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of K2 on the tensor cores that share an SM (as
    :func:`k1_blocks_per_sm` counts them)."""
    if built:
        return _built_per_sm(f"nafblk_b_{_fwd_kind(dtype)}_blocks_per_sm", c,
                             f, tile)
    table = (K2_TF32_BLOCKS_BY_REGISTERS if dtype == torch.float32
             else K2_BLOCKS_BY_REGISTERS)
    by_regs = table[c <= FWD_RESIDENT_MAX and f <= FWD_RESIDENT_MAX, tile]
    return min(by_regs, SM_SMEM // (k2_smem_bytes(c, f, tile, dtype)
                                    + FWD_STATIC_SMEM + 1024))


def k1_tile(n: int, c: int, s: int,
            dtype: torch.dtype = torch.bfloat16) -> int:
    """Pixels per tile of K1's front kernel on the tensor cores on a
    ``dtype`` ``[N, C, S]``: the widest tile that fits and still gives half
    the SMs a block, else the narrowest that fits. A tile of this kernel is
    a short chain (LN1, one product) whose fixed part a wide tile pays
    back, so fewer, wider blocks beat a full round of narrow ones
    (``chip_smoke.py`` on an H100: 2.285 ms of device time per flagship
    step, against 2.500 with K2's least-waves rule). 0 when no tile fits or
    ``C`` is no multiple of 16 (the depth of one bf16 tensor-core step, two
    of TF32)."""
    if c % 16:
        return 0
    fits = [t for t in P1_TILES
            if k1_smem_bytes(c, t, dtype) <= P1_SMEM_LIMIT]
    for t in fits:
        if n * -(-s // t) >= SM_COUNT // 2:
            return t
    return fits[-1] if fits else 0


def k2_tile(n: int, c: int, f: int, s: int, built: bool = False,
            dtype: torch.dtype = torch.bfloat16) -> int:
    """Pixels per tile of K2 on the tensor cores on a ``dtype`` ``[N, C,
    S]`` (:func:`_least_waves_tile`); 0 when no tile fits or ``C``, ``F``
    are no multiples of 16."""
    if c % 16 or f % 16:
        return 0
    return _least_waves_tile(
        n, s, lambda t: k2_smem_bytes(c, f, t, dtype),
        lambda t: k2_blocks_per_sm(c, f, t, built, dtype))


def k1_grid(n: int, c: int, s: int, tile: int, built: bool = False,
            dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks per image of K1's front kernel on the tensor cores
    (``layernorm.one_round``)."""
    return one_round(n, s, tile, k1_blocks_per_sm(c, tile, built, dtype))


def k1_dw_grid(n: int, c: int, h: int, w: int, built: bool = False,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks per (image, channel pair) of K1's depthwise kernel
    (:func:`_dw_grid`); ``dtype`` is g's, bf16 or fp32."""
    entry = ("nafblk_a_tf32_dw_blocks_per_sm" if dtype == torch.float32
             else "nafblk_a_dw_blocks_per_sm")
    per_sm = _built_per_sm(entry) if built else K1_DW_BLOCKS_PER_SM
    return _dw_grid(n, c, h, w, K1_DW_TILE, per_sm)


def k2_grid(n: int, c: int, f: int, s: int, tile: int, built: bool = False,
            dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks per image of K2 on the tensor cores
    (``layernorm.one_round``)."""
    return one_round(n, s, tile, k2_blocks_per_sm(c, f, tile, built, dtype))


def k1_geometry(dtype: torch.dtype, n: int, c: int, h: int, w: int,
                built: bool = False) -> Tuple[int, int, int]:
    """``(tile, grid, dw_grid)`` of K1's tensor-core route on a ``dtype``
    ``[N, C, H*W]`` input (:func:`k1_tile`, :func:`k1_grid`,
    :func:`k1_dw_grid`): bf16 products in bf16, 3xTF32 in fp32.
    ``(0, 0, 0)`` chooses the FMA route: a C that is no multiple of 16 or
    too wide for any tile. ``built`` takes the blocks per SM from the built
    kernels (the wrappers on CUDA), else from this module's tables."""
    tile = k1_tile(n, c, h * w, dtype) if dtype in _MMA_DTYPES else 0
    if not tile:
        return 0, 0, 0
    return (tile, k1_grid(n, c, h * w, tile, built, dtype),
            k1_dw_grid(n, c, h, w, built, dtype))


def k2_geometry(dtype: torch.dtype, n: int, c: int, f: int, s: int,
                built: bool = False) -> Tuple[int, int]:
    """``(tile, grid)`` of K2's tensor-core route on a ``dtype`` ``[N, C,
    S]`` input (:func:`k2_tile`, :func:`k2_grid`): bf16 products in bf16,
    3xTF32 in fp32. ``(0, 0)`` chooses the FMA route (C, F no multiples of
    16, or too wide for any tile). ``built`` as in :func:`k1_geometry`."""
    tile = (k2_tile(n, c, f, s, built, dtype) if dtype in _MMA_DTYPES
            else 0)
    if not tile:
        return 0, 0
    return tile, k2_grid(n, c, f, s, tile, built, dtype)


def call_a(x: torch.Tensor, p: Params, hw: Tuple[int, int],
           eps: float = 1e-6, return_t: bool = False):
    """K1 on ``x: [N, C, H*W]`` -> ``(g, sums)``; plain version on CPU.

    On CUDA the route follows :func:`k1_geometry`: C % 16 == 0 runs the
    tensor-core kernels (bf16 products, or fp32 as 3xTF32; W1 in the
    activations' type, as :class:`NAFBlockFunction` hands it over, goes to
    them with no conversion); other C run the FMA kernel (any C; W1's rows
    padded by :func:`padded_matrices` unless they come so). ``return_t``
    adds the first stage's fp32 ``t [N, 2C, H*W]``, which only the
    tensor-core routes (and on CPU the plain version) compute apart."""
    if not x.is_cuda:
        t = plain_a_front(x, p, eps)
        g, sums = plain_a_dw(t, p, hw, x.dtype)
        return (g, sums, t) if return_t else (g, sums)
    n, c, s = x.shape
    h, w = hw
    if h * w != s:
        raise ValueError(f"hw={hw} does not match H*W={s}")
    out = launch_a(x, p, hw, eps, *k1_geometry(x.dtype, n, c, h, w,
                                               built=True), return_t=return_t)
    call_a.launches += 1
    return out


call_a.launches = 0


def launch_a(x: torch.Tensor, p: Params, hw: Tuple[int, int], eps: float,
             tile: int, grid: int, dw_grid: int, return_t: bool = False):
    """K1's kernels on CUDA tensors on the route ``tile`` names (> 0: the
    tensor-core kernels with that tile and grids; 0: the FMA kernel) ->
    what :func:`call_a` returns, uncounted. :func:`call_a` chooses the
    route from dtype and shape alone; ``chip_smoke.py`` also runs the FMA
    route where the tensor cores are chosen, to time both in one run."""
    n, c, s = x.shape
    h, w = hw
    p = padded_matrices(p)
    if p["W1"].shape != (2 * c, row_pitch(c)):
        raise ValueError(
            f"K1 needs dw_expand == 2 (W1 [2C, C]); got W1 {tuple(p['W1'].shape)}")
    _check_cuda(x, p, _A_PARAMS)
    if return_t and not tile:
        raise ValueError("the FMA route of K1 keeps t in shared memory")
    lib = _build.load()
    bf16 = int(x.dtype == torch.bfloat16)
    ws_bytes = lib.nafblk_a_workspace(n, c, h, w, bf16, tile, grid, dw_grid)
    if ws_bytes < 0:
        raise ValueError(f"K1 does not take C={c} on {h}x{w} with tile "
                         f"{tile}, grids {grid}, {dw_grid}")
    cdt = _compute_dtype(x)
    args = _kernel_args(p, _A_PARAMS, cdt,
                        matrices=cdt if tile else torch.float32)
    g = torch.empty_like(x)
    sums = torch.empty((n, c), device=x.device, dtype=torch.float32)
    ws = torch.empty(ws_bytes, device=x.device, dtype=torch.uint8)
    # the front stage's output, rows of H*W rounded up to 8 (16-byte rows)
    t = (torch.empty((n, 2 * c, -(-s // 8) * 8), device=x.device,
                     dtype=torch.float32) if tile else None)
    rc = _build.launch(x, lib.nafblk_a, x.data_ptr(),
                       *[a.data_ptr() for a in args], g.data_ptr(),
                       sums.data_ptr(), t.data_ptr() if tile else None,
                       ws.data_ptr(), n, c, h, w, float(eps), bf16, tile,
                       grid, dw_grid)
    if rc != 0:
        raise RuntimeError(f"nafblk_a launch failed: CUDA error {rc}")
    return (g, sums, t[:, :, :s]) if return_t else (g, sums)


def call_b(x: torch.Tensor, g: torch.Tensor, att: torch.Tensor, p: Params,
           eps: float = 1e-6) -> torch.Tensor:
    """K2 on ``x, g: [N, C, H*W]``, ``att: [N, C]``; plain version on CPU.

    On CUDA the route follows :func:`k2_geometry`: C and F multiples of 16
    run the tensor-core kernel (bf16 products in ``k2_mma_kernel``, fp32 as
    3xTF32 in ``k2_tf32_kernel``; W3, W4, W5 in the activations' type, as
    :class:`NAFBlockFunction` hands them over); other C or F run the FMA
    kernel (any C, F with (2C + F) x 16 fp32 values in shared memory; rows
    padded as in :func:`call_a`)."""
    if not x.is_cuda:
        return plain_b(x, g, att, p, eps)
    n, c, s = x.shape
    f = p["W4"].shape[0] // 2
    out = launch_b(x, g, att, p, eps,
                   *k2_geometry(x.dtype, n, c, f, s, built=True))
    call_b.launches += 1
    return out


call_b.launches = 0


def launch_b(x: torch.Tensor, g: torch.Tensor, att: torch.Tensor, p: Params,
             eps: float, tile: int, grid: int) -> torch.Tensor:
    """K2's kernel on CUDA tensors on the route ``tile`` names (as
    :func:`launch_a`) -> what :func:`call_b` returns, uncounted."""
    n, c, s = x.shape
    p = padded_matrices(p)
    f = p["W4"].shape[0] // 2
    _like_x(x, g=g)
    if (p["W4"].shape != (2 * f, row_pitch(c))
            or p["W3"].shape != (c, row_pitch(c))
            or p["W5"].shape != (c, row_pitch(f))):
        raise ValueError(f"K2 needs W3 [C, C], W4 [2F, C] and W5 [C, F]; got "
                         f"W3 {tuple(p['W3'].shape)}, "
                         f"W4 {tuple(p['W4'].shape)}")
    _check_cuda(x, p, _B_PARAMS)
    lib = _build.load()
    if not tile and lib.nafblk_b_pixels(c, f) == 0:
        raise ValueError(
            f"K2 keeps (2C+F) x 16 fp32 values per block in shared memory; "
            f"C={c}, F={f} does not fit")
    cdt = _compute_dtype(x)
    args = _kernel_args(p, _B_PARAMS, cdt,
                        matrices=cdt if tile else torch.float32)
    att = att.detach().float().contiguous()
    out = torch.empty_like(x)
    rc = _build.launch(x, lib.nafblk_b, x.data_ptr(), g.data_ptr(),
                       att.data_ptr(), *[t.data_ptr() for t in args],
                       out.data_ptr(), n, c, f, s, float(eps),
                       int(x.dtype == torch.bfloat16), tile, grid)
    if rc != 0:
        raise RuntimeError(f"nafblk_b launch failed: CUDA error {rc}")
    return out


_P2_PARAMS = ("w1n", "b1n", "W1", "b1", "kdw", "bk", "W3", "beta")


def _split(flat: torch.Tensor, layout) -> Params:
    """Views of consecutive pieces of ``flat`` named and shaped by
    ``layout``."""
    out, o = {}, 0
    for name, shape in layout:
        size = 1
        for d in shape:
            size *= d
        out[name] = flat[o:o + size].view(shape)
        o += size
    return out


# Geometry of the bf16 K3 (csrc/nafblock_p1_mma.cuh): pixel tiles of 32, 16
# or 8; bf16 operand rows padded by 8 elements above 8 pixels; a ring of
# three weight slabs of 128 x 32 bf16 values or, up to 64 channels, the
# three matrices themselves (rows padded by 8) with 13C + 4F fp32 vectors
# and partials; a block may use 227 KB less 2 KB of static scratch. The tile
# and the grid are chosen here and handed to the kernel, which only checks
# them. An H100 has 132 SMs of 228 KB shared memory (1 KB of it reserved
# for each block); the kernel's registers allow two blocks on an SM, three
# with resident weights. chip_smoke.py holds p1_smem_bytes against the
# kernel's own sum and p1_blocks_per_sm against the occupancy the CUDA
# runtime reports for the built kernel.
P1_TILES = (32, 16, 8)
P1_SMEM_LIMIT = 232448 - 2048
P1_SLAB_BYTES = 3 * 128 * 32 * 2
P1_RESIDENT_MAX = 64
SM_SMEM = 233472
P1_BLOCKS_BY_REGISTERS = {False: 2, True: 3}  # ring / resident weights
# The fp32 K3 on the tensor cores (csrc/nafblock_tf32.cuh, 3xTF32): the
# same tiles and phases with fp32 operands [channels][rows]; up to 64
# channels the three matrices stay resident in fp32 (rows padded by 8)
# with the 13C + 4F vectors and partials, above no shared memory goes to
# weights (each warp reads its rows of them from global memory). Blocks
# that its registers allow on an SM, by (resident weights, tile), as the
# CUDA runtime counts them for the built kernel on an H100 (chip_smoke.py
# holds them against it).
P1_TF32_BLOCKS_BY_REGISTERS = {(False, 32): 2, (False, 16): 2, (False, 8): 2,
                               (True, 32): 3, (True, 16): 3, (True, 8): 3}
# A tile's time grows as overhead + pixels: the weight slabs a block walks
# do not depend on its pixels. Fitted on an H100 to k3_mma_kernel at every
# tile that fits (the table is in PERF.md; at C=128 on 96x96, five waves
# either way: 0.184 ms with 32 pixels, 0.151 ms with 16).
P1_TILE_OVERHEAD = 72


def p1_smem_bytes(c: int, f: int, tile: int,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of K3 on the tensor cores with ``tile`` pixels
    per block: the operands ``v|h2, wv -> dq`` (``max(C + F, 2F)`` rows)
    and ``ds -> dp`` (C rows) in ``dtype`` (bf16, or fp32 for 3xTF32),
    fp32 ``z``, ``pth`` (C rows each) and ``q`` (2F rows), and the weights:
    in bf16 the slabs or the resident matrices, in fp32 the resident
    matrices or none."""
    ldb = tile if tile == 8 else tile + 8
    resident = c <= P1_RESIDENT_MAX and f <= P1_RESIDENT_MAX
    mats = (c + 2 * f) * (c + 8) + c * (f + 8)
    if dtype == torch.float32:
        weights = mats + 13 * c + 4 * f if resident else 0
        return ((max(c + f, 2 * f) + c) * ldb + (2 * c + 2 * f) * tile
                + weights) * 4
    weights = P1_SLAB_BYTES
    if resident:
        weights = mats * 2 + (13 * c + 4 * f) * 4
    return ((max(c + f, 2 * f) + c) * ldb * 2 + (2 * c + 2 * f) * tile * 4
            + weights)


def p1_blocks_per_sm(c: int, f: int, tile: int,
                     dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of K3 on the tensor cores (bf16, or fp32 for 3xTF32) that
    share an SM: as many as its registers and its shared memory (dynamic,
    2 KB static, 1 KB reserved) allow."""
    resident = max(c, f) <= P1_RESIDENT_MAX
    by_regs = (P1_TF32_BLOCKS_BY_REGISTERS[resident, tile]
               if dtype == torch.float32 else
               P1_BLOCKS_BY_REGISTERS[resident])
    return min(by_regs, SM_SMEM // (p1_smem_bytes(c, f, tile, dtype)
                                    + 2048 + 1024))


def _least_waves_tile(n: int, s: int, smem, per_sm) -> int:
    """Of the tiles whose ``smem(tile)`` fits, the one with the least
    ``waves * (overhead + pixels)``, where a wave is one round of
    ``per_sm(tile)`` blocks on each SM; the wider tile on a tie. While
    everything fits in one wave that is the narrowest tile, so a small
    image still spreads over the SMs. 0 when no tile fits."""
    best, best_cost = 0, None
    for t in P1_TILES:
        if smem(t) > P1_SMEM_LIMIT:
            continue
        waves = -(-(n * -(-s // t)) // (SM_COUNT * per_sm(t)))
        cost = waves * (P1_TILE_OVERHEAD + t)
        if best_cost is None or cost < best_cost:
            best, best_cost = t, cost
    return best


def p1_grid(n: int, c: int, f: int, s: int, tile: int,
            dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks per image of K3 on the tensor cores
    (``layernorm.one_round``)."""
    return one_round(n, s, tile, p1_blocks_per_sm(c, f, tile, dtype))


def p1_tile(n: int, c: int, f: int, s: int,
            dtype: torch.dtype = torch.bfloat16) -> int:
    """Pixels per block of K3 on the tensor cores on a ``dtype`` ``[N, C,
    S]`` (:func:`_least_waves_tile` over :func:`p1_smem_bytes` and
    :func:`p1_blocks_per_sm`; the fp32 kernel's time is taken to grow with
    a tile as the bf16 one's). 0 when no tile fits or ``C``, ``F`` are no
    multiples of 16 (the depth of one bf16 tensor-core step, two of
    TF32)."""
    if c % 16 or f % 16:
        return 0
    return _least_waves_tile(n, s, lambda t: p1_smem_bytes(c, f, t, dtype),
                             lambda t: p1_blocks_per_sm(c, f, t, dtype))


# Pixels per block of the FMA route of K3 and K4 (csrc/nafblock_bwd.cu:
# p1_pixels, p2_pixels; C or F no multiple of 16, or no tensor-core tile
# that fits): K3
# keeps (4C + 3F) fp32 rows of P pixels in shared memory, K4's back kernel
# 4C. chip_smoke.py holds both against the built library's counts.
def p1_fma_pixels(c: int, f: int) -> int:
    """Pixels per block of K3's FMA kernel; 0 when no tile fits."""
    for t in P1_TILES:
        if (4 * c + 3 * f) * t * 4 <= P1_SMEM_LIMIT:
            return t
    return 0


_MMA_DTYPES = (torch.bfloat16, torch.float32)


def p1_geometry(dtype: torch.dtype, n: int, c: int, f: int,
                s: int) -> Tuple[int, int]:
    """``(tile, grid)`` of K3's tensor-core route on a ``dtype`` ``[N, C,
    S]`` input (:func:`p1_tile`, :func:`p1_grid`): bf16 products in bf16,
    3xTF32 in fp32. ``(0, 0)`` chooses the FMA route: C, F no multiples of
    16, or too wide for any tile."""
    tile = p1_tile(n, c, f, s, dtype) if dtype in _MMA_DTYPES else 0
    return (tile, p1_grid(n, c, f, s, tile, dtype)) if tile else (0, 0)


def rounded_matrices(p: Params, dt: torch.dtype) -> Params:
    """``p`` with its matrices rounded to bf16 for a block that runs in
    bf16 (``p`` itself otherwise): the four kernels of one forward and
    backward then share one rounding of each matrix, and K3 gets its bf16
    operands without a conversion of its own."""
    if dt != torch.bfloat16:
        return p
    return {k: t.detach().to(torch.bfloat16) if k in _MATRICES else t
            for k, t in p.items()}


def p1_operands(p: Params, cdt: torch.dtype, mma: bool = True) -> list:
    """K3's ten parameters as its kernels take them: W3, W4, W5 rounded to
    ``cdt`` and handed over in ``cdt`` on the tensor-core route (``mma``:
    bf16 matrices go to the tensor cores as they are, fp32 ones are split
    in the kernel), in fp32 on the FMA route; vectors fp32."""
    return _kernel_args(p, _B_PARAMS, cdt,
                        matrices=cdt if mma else torch.float32)


def call_p1(x: torch.Tensor, g: torch.Tensor, dout: torch.Tensor,
            att: torch.Tensor, p: Params, eps: float = 1e-6):
    """K3 on ``x, g, dout: [N, C, H*W]``, ``att: [N, C]`` -> ``(dz, da,
    grads)``; plain version on CPU. On CUDA the route follows
    :func:`p1_geometry`: the tensor-core kernels (bf16, or fp32 as
    3xTF32), or the FMA kernel (C or F no multiple of 16, or no tile that
    fits; any C, F, the matrix rows padded as in :func:`call_a`). The
    weight grads come at true shapes."""
    if not x.is_cuda:
        return plain_p1(x, g, dout, att, p, eps)
    n, c, s = x.shape
    tile, grid = p1_geometry(x.dtype, n, c, p["W4"].shape[0] // 2, s)
    out = launch_p1(x, g, dout, att, p, eps, tile, grid)
    call_p1.launches += 1
    return out


call_p1.launches = 0


def launch_p1(x: torch.Tensor, g: torch.Tensor, dout: torch.Tensor,
              att: torch.Tensor, p: Params, eps: float, tile: int,
              grid: int):
    """K3's kernels on CUDA tensors on the route ``tile`` names (> 0: the
    tensor-core kernels with that tile and grid; 0: the FMA kernel) ->
    what :func:`call_p1` returns, uncounted. :func:`call_p1` chooses the
    route from dtype and shape alone; ``chip_smoke.py`` also runs the FMA
    route where the tensor cores are chosen, to time both in one run."""
    n, c, s = x.shape
    p = padded_matrices(p)
    f = p["W4"].shape[0] // 2
    _like_x(x, g=g, dout=dout)
    if (p["W4"].shape != (2 * f, row_pitch(c))
            or p["W3"].shape != (c, row_pitch(c))
            or p["W5"].shape != (c, row_pitch(f))):
        raise ValueError(f"K3 needs W3 [C, C], W4 [2F, C], W5 [C, F]; got "
                         f"W4 {tuple(p['W4'].shape)}")
    _check_cuda(x, p, _B_PARAMS)
    lib = _build.load("nafblock_bwd")
    bf16 = int(x.dtype == torch.bfloat16)
    ws_bytes = lib.nafblk_p1_workspace(n, c, f, s, bf16, tile, grid)
    if ws_bytes < 0:
        raise ValueError(f"K3 takes no C={c}, F={f} on {s} pixels: no "
                         f"tensor-core tile fits (tile {tile}, grid {grid}) "
                         f"and the FMA route keeps (4C+3F) x 8 fp32 values "
                         f"per block in shared memory")
    args = p1_operands(p, _compute_dtype(x), mma=tile > 0)
    att = att.detach().float().contiguous()
    dz = torch.empty_like(dout)
    da = torch.empty((n, c), device=x.device, dtype=torch.float32)
    layout = [("W3", (c, c)), ("W4", (2 * f, c)), ("W5", (c, f)),
              ("gamma", (c,)), ("b5", (c,)), ("b4", (2 * f,)),
              ("w2n", (c,)), ("b2n", (c,)), ("beta", (c,)), ("b3", (c,))]
    grads = torch.empty(c * c + 3 * f * c + 6 * c + 2 * f,
                        device=x.device, dtype=torch.float32)
    ws = torch.empty(ws_bytes, device=x.device, dtype=torch.uint8)
    rc = _build.launch(x, lib.nafblk_p1, x.data_ptr(), g.data_ptr(),
                       dout.data_ptr(), att.data_ptr(),
                       *[t.data_ptr() for t in args], dz.data_ptr(),
                       da.data_ptr(), grads.data_ptr(), ws.data_ptr(), n, c,
                       f, s, float(eps), bf16, tile, grid)
    if rc != 0:
        raise RuntimeError(f"nafblk_p1 launch failed: CUDA error {rc}")
    return dz, da, _split(grads, layout)


# Geometry of the bf16 K4 (csrc/nafblock_p2_mma.cuh): its two pixel-tile
# kernels take the tiles of K3 (32, 16 or 8 pixels, bf16 rows padded by 8
# above 8 pixels) and keep, beside the tile, W1 and W3 (rows padded by 8)
# in shared memory up to 64 channels, else the ring of three weight slabs.
#   front: x fp32 [C][tile], h then beta*dz bf16 [C][rows], W1 + W3
#   back:  dt bf16 [2C][rows], xhat and dh fp32 [C][tile] each, W1
# The depthwise kernel takes 2-D tiles of 32 x 32 pixels and one channel
# pair a block. chip_smoke.py holds p2_smem_bytes against the kernels' own
# sums and p2_blocks_per_sm / P2_DW_BLOCKS_PER_SM against the occupancy
# the CUDA runtime reports for the built kernels.
P2_RESIDENT_MAX = 64
# Blocks of the pixel-tile kernels that their registers allow on an SM, by
# (resident weights, tile), as the CUDA runtime counts them for the built
# kernels on an H100 (the fewer of front and back)
P2_BLOCKS_BY_REGISTERS = {(False, 32): 2, (False, 16): 2, (False, 8): 3,
                          (True, 32): 3, (True, 16): 3, (True, 8): 4}
P2_DW_TILE = (32, 32)
P2_DW_BLOCKS_PER_SM = 3
# The fp32 K4 on the tensor cores (csrc/nafblock_tf32.cuh, 3xTF32): the
# same kernels with fp32 operands and streams; up to 64 channels W1 and W3
# stay resident in fp32, above no shared memory goes to weights. Blocks by
# registers as counted for the built kernels on an H100; its depthwise
# kernel (dt out in fp32) shares the bf16 one's P2_DW_BLOCKS_PER_SM.
#   front: x fp32 [C][tile], h then beta*dz fp32 [C][rows], W1 + W3
#   back:  dt fp32 [2C][rows], xhat and dh fp32 [C][tile] each, W1
P2_TF32_BLOCKS_BY_REGISTERS = {(False, 32): 2, (False, 16): 2, (False, 8): 2,
                               (True, 32): 3, (True, 16): 3, (True, 8): 3}


def p2_smem_bytes(c: int, tile: int,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of K4's pixel-tile kernels on the tensor cores
    (bf16, or fp32 for 3xTF32) with ``tile`` pixels: the larger of the
    front and the back kernel's."""
    ldb = tile if tile == 8 else tile + 8
    resident = c <= P2_RESIDENT_MAX
    if dtype == torch.float32:
        front = c * tile + c * ldb + (3 * c * (c + 8) if resident else 0)
        back = 2 * c * ldb + 2 * c * tile + (2 * c * (c + 8) if resident
                                             else 0)
        return max(front, back) * 4
    front_w = 3 * c * (c + 8) * 2 if resident else P1_SLAB_BYTES
    back_w = 2 * c * (c + 8) * 2 if resident else P1_SLAB_BYTES
    front = c * tile * 4 + c * ldb * 2 + front_w
    back = 2 * c * ldb * 2 + 2 * c * tile * 4 + back_w
    return max(front, back)


def p2_blocks_per_sm(c: int, tile: int,
                     dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of K4's pixel-tile kernels on the tensor cores (bf16, or fp32
    for 3xTF32) that share an SM: as many as their registers and shared
    memory (dynamic, 2 KB static, 1 KB reserved) allow."""
    table = (P2_TF32_BLOCKS_BY_REGISTERS if dtype == torch.float32
             else P2_BLOCKS_BY_REGISTERS)
    by_regs = table[c <= P2_RESIDENT_MAX, tile]
    return min(by_regs, SM_SMEM // (p2_smem_bytes(c, tile, dtype)
                                    + 2048 + 1024))


def p2_tile(n: int, c: int, s: int,
            dtype: torch.dtype = torch.bfloat16) -> int:
    """Pixels per tile of K4 on the tensor cores on a ``dtype`` ``[N, C,
    S]``, chosen as K3's (:func:`_least_waves_tile` over
    :func:`p2_smem_bytes` and :func:`p2_blocks_per_sm`). 0 when no tile
    fits or ``C`` is no multiple of 16."""
    if c % 16:
        return 0
    return _least_waves_tile(n, s, lambda t: p2_smem_bytes(c, t, dtype),
                             lambda t: p2_blocks_per_sm(c, t, dtype))


def p2_grid(n: int, c: int, s: int, tile: int,
            dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks per image of K4's pixel-tile kernels on the tensor cores
    (``layernorm.one_round``)."""
    return one_round(n, s, tile, p2_blocks_per_sm(c, tile, dtype))


def _dw_grid(n: int, c: int, h: int, w: int, tile, per_sm: int) -> int:
    """Blocks per (image, channel pair) of a depthwise kernel whose blocks
    each walk that pair's 2-D tiles in strides: one round of blocks over
    the card, no more than there are tiles."""
    tiles = -(-h // tile[0]) * -(-w // tile[1])
    return max(1, min(tiles, SM_COUNT * per_sm // (n * c)))


def p2_dw_grid(n: int, c: int, h: int, w: int) -> int:
    """Blocks per (image, channel pair) of the bf16 K4's depthwise kernel
    (:func:`_dw_grid`)."""
    return _dw_grid(n, c, h, w, P2_DW_TILE, P2_DW_BLOCKS_PER_SM)


def p2_fma_pixels(c: int) -> int:
    """Pixels per block of K4's FMA back kernel (4C fp32 rows of the
    tile in shared memory); 0 when no tile fits."""
    for t in P1_TILES:
        if 4 * c * t * 4 <= P1_SMEM_LIMIT:
            return t
    return 0


def p2_geometry(dtype: torch.dtype, n: int, c: int, h: int,
                w: int) -> Tuple[int, int, int]:
    """``(tile, grid, dw_grid)`` of K4's tensor-core route on a ``dtype``
    ``[N, C, H*W]`` input (:func:`p2_tile`, :func:`p2_grid`,
    :func:`p2_dw_grid`): bf16 products in bf16, 3xTF32 in fp32.
    ``(0, 0, 0)`` chooses the FMA route: a C that is no multiple of 16 or
    too wide for any tile."""
    tile = p2_tile(n, c, h * w, dtype) if dtype in _MMA_DTYPES else 0
    if not tile:
        return 0, 0, 0
    return (tile, p2_grid(n, c, h * w, tile, dtype),
            p2_dw_grid(n, c, h, w))


def call_p2(x: torch.Tensor, dz: torch.Tensor, dgc: torch.Tensor,
            att: torch.Tensor, p: Params, hw: Tuple[int, int],
            eps: float = 1e-6):
    """K4 on ``x, dz: [N, C, H*W]``, ``dgc, att: [N, C]`` -> ``(dx,
    grads)``; plain version on CPU. On CUDA the route follows
    :func:`p2_geometry`: on the tensor-core route W1 and W3 go to the
    kernels in the activations' type (bf16 as :class:`NAFBlockFunction`
    hands them over, with no conversion; fp32 for 3xTF32); the FMA route
    (C no multiple of 16, or no tile that fits) takes them in fp32, rows
    padded as in :func:`call_a`."""
    if not x.is_cuda:
        return plain_p2(x, dz, dgc, att, p, hw, eps)
    n, c, s = x.shape
    h, w = hw
    if h * w != s:
        raise ValueError(f"hw={hw} does not match H*W={s}")
    out = launch_p2(x, dz, dgc, att, p, hw, eps,
                    *p2_geometry(x.dtype, n, c, h, w))
    call_p2.launches += 1
    return out


call_p2.launches = 0


def launch_p2(x: torch.Tensor, dz: torch.Tensor, dgc: torch.Tensor,
              att: torch.Tensor, p: Params, hw: Tuple[int, int], eps: float,
              tile: int, grid: int, dw_grid: int):
    """K4's kernels on CUDA tensors on the route ``tile`` names (as
    :func:`launch_p1`) -> what :func:`call_p2` returns, uncounted."""
    n, c, s = x.shape
    h, w = hw
    _like_x(x, dz=dz)
    p = padded_matrices(p)
    if (p["W1"].shape != (2 * c, row_pitch(c))
            or p["W3"].shape != (c, row_pitch(c))):
        raise ValueError(f"K4 needs W1 [2C, C] and W3 [C, C]; got W1 "
                         f"{tuple(p['W1'].shape)}")
    _check_cuda(x, p, _P2_PARAMS)
    lib = _build.load("nafblock_bwd")
    bf16 = int(x.dtype == torch.bfloat16)
    ws_bytes = lib.nafblk_p2_workspace(n, c, h, w, bf16, tile, grid, dw_grid)
    if ws_bytes < 0:
        raise ValueError(f"K4 takes no C={c} on {h}x{w}: no tensor-core tile "
                         f"fits (tile {tile}, grids {grid}, {dw_grid}) and "
                         f"the FMA route keeps 4C x 8 fp32 values per block "
                         f"in shared memory")
    cdt = _compute_dtype(x)
    args = _kernel_args(p, _P2_PARAMS, cdt,
                        matrices=cdt if tile else torch.float32)
    dgc = dgc.detach().float().contiguous()
    att = att.detach().float().contiguous()
    dx = torch.empty_like(dz)
    grads = torch.empty(2 * c * c + 24 * c, device=x.device,
                        dtype=torch.float32)
    ws = torch.empty(ws_bytes, device=x.device, dtype=torch.uint8)
    rc = _build.launch(x, lib.nafblk_p2, x.data_ptr(), dz.data_ptr(),
                       dgc.data_ptr(), att.data_ptr(),
                       *[t.data_ptr() for t in args], dx.data_ptr(),
                       grads.data_ptr(), ws.data_ptr(), n, c, h, w,
                       float(eps), bf16, tile, grid, dw_grid)
    if rc != 0:
        raise RuntimeError(f"nafblk_p2 launch failed: CUDA error {rc}")
    out = _split(grads, [("W1", (2 * c, c)), ("taps", (11, 2 * c)),
                         ("w1n", (c,)), ("b1n", (c,))])
    taps = out.pop("taps")
    out.update(kdw=taps[:9].t().contiguous(), bk=taps[9], b1=taps[10])
    return dx, out

# ---------------------------------------------------------------------------
# K1 and K2 as registered ops (what torch.export sees of a fused block)
# ---------------------------------------------------------------------------


@torch.library.custom_op("llie_torch::nafblock_a", mutates_args=(),
                         device_types="cpu")
def nafblock_a(x: torch.Tensor, params: List[torch.Tensor], h: int, w: int,
               eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on ``x: [N, C, H*W]`` with ``params`` the views of
    ``_A_PARAMS`` -> ``(g like x, sums [N, C] fp32)``; this CPU kernel is
    the plain version."""
    return plain_a(x, dict(zip(_A_PARAMS, params)), (h, w), eps)


@nafblock_a.register_kernel("cuda")
def _nafblock_a_cuda(x, params, h, w, eps):
    return call_a(x, dict(zip(_A_PARAMS, params)), (h, w), eps)


@nafblock_a.register_fake
def _nafblock_a_fake(x, params, h, w, eps):
    return (torch.empty_like(x),
            x.new_empty((x.shape[0], x.shape[1]), dtype=torch.float32))


@torch.library.custom_op("llie_torch::nafblock_b", mutates_args=(),
                         device_types="cpu")
def nafblock_b(x: torch.Tensor, g: torch.Tensor, att: torch.Tensor,
               params: List[torch.Tensor], eps: float) -> torch.Tensor:
    """K2 on ``x, g: [N, C, H*W]``, ``att: [N, C]`` with ``params`` the
    views of ``_B_PARAMS`` -> the block output like ``x``; this CPU kernel
    is the plain version."""
    return plain_b(x, g, att, dict(zip(_B_PARAMS, params)), eps)


@nafblock_b.register_kernel("cuda")
def _nafblock_b_cuda(x, g, att, params, eps):
    return call_b(x, g, att, dict(zip(_B_PARAMS, params)), eps)


@nafblock_b.register_fake
def _nafblock_b_fake(x, g, att, params, eps):
    return torch.empty_like(x)


# FLOPs of the two ops for torch.utils.flop_counter (2 per multiply-add,
# products only), as the counter counts their plain versions' aten ops: K1
# conv1 [2C, C] and the depthwise 3x3 over 2C channels; K2 conv3 [C, C],
# conv4 [2F, C], conv5 [C, F]. The counter cannot see inside an op.
@register_flop_formula(torch.ops.llie_torch.nafblock_a)
def _nafblock_a_flops(x_shape, params_shape, h, w, eps, *args,
                      **kwargs) -> int:
    n, c, s = x_shape
    return 2 * n * s * (2 * c * c + 2 * c * 9)


@register_flop_formula(torch.ops.llie_torch.nafblock_b)
def _nafblock_b_flops(x_shape, g_shape, att_shape, params_shape, eps, *args,
                      **kwargs) -> int:
    n, c, s = x_shape
    f = params_shape[_B_PARAMS.index("W4")][0] // 2
    return 2 * n * s * (c * c + 2 * f * c + c * f)


# the 18 packed views in pack_params order (NAFBlockFunction's inputs)
PARAM_ORDER = ("w1n", "b1n", "W1", "b1", "kdw", "bk", "Wsca", "bsca", "W3",
               "b3", "w2n", "b2n", "W4", "b4", "W5", "b5", "beta", "gamma")


class NAFBlockFunction(torch.autograd.Function):
    """One NAFBlock with the fused forward (K1 -> SCA -> K2, through the
    registered ops :func:`nafblock_a`, :func:`nafblock_b`) and the fused
    backward (K3 -> SCA backward -> K4): the counterpart of the JAX
    ``fused_nafblock`` custom VJP. Saves ``(x, g, m, att)`` as the JAX
    ``_vjp_fwd`` does (and, in bf16, the four matrices as rounded once for
    all four kernels, and where a row's length is no multiple of 4 with
    the rows padded once for all four), and returns ``dx`` and a grad for
    each packed view at its own shape.

    ``apply(x, hw, eps, *params)`` with ``x: [N, C, H*W]`` and ``params``
    the 18 views in :data:`PARAM_ORDER`."""

    @staticmethod
    def forward(ctx, x, hw, eps, *params):
        given = dict(zip(PARAM_ORDER, params))
        p = padded_matrices(rounded_matrices(given, x.dtype))
        area = hw[0] * hw[1]
        g, sums = nafblock_a(x, [p[k] for k in _A_PARAMS], hw[0], hw[1],
                             eps)
        att = sca_attention(sums, p, area)
        out = nafblock_b(x, g, att, [p[k] for k in _B_PARAMS], eps)
        # the rounded (padded) matrices go to the backward beside the
        # parameters
        rounded = [] if p is given else [p[k] for k in _MATRICES]
        ctx.save_for_backward(x, g, sums / float(area), att, *params,
                              *rounded)
        ctx.hw, ctx.eps = hw, eps
        return out

    @staticmethod
    def backward(ctx, dout):
        x, g, m, att, *params = ctx.saved_tensors
        params, rounded = params[:len(PARAM_ORDER)], params[len(PARAM_ORDER):]
        given = dict(zip(PARAM_ORDER, params))
        p = {**given, **dict(zip(_MATRICES, rounded))}
        hw = ctx.hw
        dz, da, grads = call_p1(x, g, dout.contiguous(), att, p, ctx.eps)
        dwsca, dbsca, dgc = sca_backward(da, m, p, hw[0] * hw[1])
        dx, first = call_p2(x, dz, dgc, att, p, hw, ctx.eps)
        grads.update(first, Wsca=dwsca, bsca=dbsca)
        return (dx, None, None,
                *[grads[k].to(given[k].dtype) for k in PARAM_ORDER])


def nafblock_fwd(x: torch.Tensor, p: Params, hw: Tuple[int, int],
                 eps: float = 1e-6) -> torch.Tensor:
    """One NAFBlock on ``x: [N, C, H*W]`` through :class:`NAFBlockFunction`
    (K1 -> SCA -> K2 forward, K3 -> K4 backward; plain versions on CPU)."""
    return NAFBlockFunction.apply(x, tuple(hw), float(eps),
                                  *[p[k] for k in PARAM_ORDER])


def reset_launch_counts() -> None:
    call_a.launches = 0
    call_b.launches = 0
    call_p1.launches = 0
    call_p2.launches = 0
