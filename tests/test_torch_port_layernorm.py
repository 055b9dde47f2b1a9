"""The port's channel LayerNorm (the plain versions of kernels K5/K6 and
``LayerNorm2dFunction``) held against the JAX package.

References: ``layer_norm_2d_pallas`` in interpret mode (rows a multiple of
256, as ``tests/test_pallas_kernels.py`` runs it; it keeps ``xhat`` in
fp32, as the port does) and ``jax.grad`` of the jnp ``layer_norm_2d``.
Tolerances, relative to max|ref|: fp32 1e-5 (summation order), bf16 2**-6
(a rounding of the stored result may land on the other side; against the
jnp version also its bf16-rounded ``xhat``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.ops.layernorm import (
    layer_norm_2d as jlayer_norm_2d,
)
from lowlight_image_enhancement_tpu.ops.pallas import layernorm as jpl
from lowlight_image_enhancement_tpu_torch.ops import layernorm as ln
from lowlight_image_enhancement_tpu_torch.ops import nafblock

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS = 1e-6


def _data(shape=(1, 16, 16, 32), seed=0):
    """NHWC x, cotangent g, and [C] weight / bias."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32) * 2 + 0.5,
            rng.standard_normal(shape).astype(np.float32),
            rng.uniform(0.5, 1.5, (c,)).astype(np.float32),
            rng.standard_normal((c,)).astype(np.float32))


def _nchw(a, dt):
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2))).to(dt)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _f32(a):
    return np.asarray(a.astype(jnp.float32))


def _close(got, ref, tol, what):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _rows(t):
    """[N, C, S] -> the JAX kernels' [N*S, C] rows."""
    return t.detach().float().permute(0, 2, 1).reshape(-1, t.shape[1]).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernels_match_pallas_calls(dtype):
    x, g, w, b = _data()
    xj = jnp.asarray(x, JDT[dtype]).reshape(-1, x.shape[-1])
    gj = jnp.asarray(g, JDT[dtype]).reshape(-1, x.shape[-1])
    y_j, xhat_j, rstd_j = jpl._fwd_call(xj, jnp.asarray(w), jnp.asarray(b),
                                        EPS)
    gx_j, gw_j, gb_j = jpl._bwd_call(gj, xhat_j, rstd_j, jnp.asarray(w))

    xt = _nchw(x, TDT[dtype]).flatten(2)
    gt = _nchw(g, TDT[dtype]).flatten(2)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    y, xhat, rstd = ln.plain_ln_fwd(xt, wt, bt, EPS)
    assert y.dtype == TDT[dtype] and xhat.dtype == rstd.dtype == torch.float32
    assert xhat.shape == xt.shape and rstd.shape == (1, 256)
    gx, gw, gb = ln.plain_ln_bwd(gt, xhat, rstd, wt)
    assert gx.dtype == TDT[dtype] and gw.dtype == gb.dtype == torch.float32

    tol = TOL[dtype]
    _close(_rows(y), _f32(y_j), tol, "y")
    _close(_rows(xhat), np.asarray(xhat_j), 1e-5, "xhat")
    _close(rstd.numpy().reshape(-1, 1), np.asarray(rstd_j), 1e-5, "rstd")
    _close(_rows(gx), _f32(gx_j), tol, "gx")
    _close(gw.numpy(), np.asarray(gw_j), 1e-5, "gw")
    _close(gb.numpy(), np.asarray(gb_j), 1e-5, "gb")


def _jax_grads(fn, x, g, w, b, dtype):
    def loss(a, ww, bb):
        y = fn(a, ww, bb, EPS)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g))

    xj = jnp.asarray(x, JDT[dtype])
    y = fn(xj, jnp.asarray(w), jnp.asarray(b), EPS)
    grads = jax.grad(loss, argnums=(0, 1, 2))(xj, jnp.asarray(w),
                                              jnp.asarray(b))
    return y, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_function_matches_jax_value_and_grads(ref, dtype):
    x, g, w, b = _data(seed=3)
    fn = jpl.layer_norm_2d_pallas if ref == "pallas" else jlayer_norm_2d
    y_j, (gx_j, gw_j, gb_j) = _jax_grads(fn, x, g, w, b, dtype)

    xt = _nchw(x, TDT[dtype]).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = ln.layer_norm_2d_auto(xt, wt, bt, EPS)
    assert y.dtype == TDT[dtype] and y.shape == xt.shape
    gx, gw, gb = torch.autograd.grad(
        (y.float() * _nchw(g, torch.float32)).sum(), (xt, wt, bt))
    assert gx.dtype == TDT[dtype] and gw.dtype == torch.float32

    tol = TOL[dtype]
    _close(_nhwc(y), _f32(y_j), tol, "y")
    _close(_nhwc(gx), _f32(gx_j), tol, "gx")
    # the jnp version sums g * xhat with xhat rounded to bf16
    wtol = tol if (ref == "jnp" and dtype == "bfloat16") else 1e-5
    _close(gw.numpy(), np.asarray(gw_j), wtol, "gw")
    _close(gb.numpy(), np.asarray(gb_j), 1e-5, "gb")


def test_module_runs_the_function_and_matches_the_eager_forward():
    x, g, w, b = _data((2, 5, 7, 12), seed=5)     # a ragged S = 35
    mod = ln.LayerNorm2d(12)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
    xt = _nchw(x, torch.float32).requires_grad_(True)
    y = mod(xt)
    assert isinstance(y.grad_fn, ln.LayerNorm2dFunction._backward_cls)
    ref = ln.layer_norm_2d(xt, mod.weight, mod.bias, mod.eps)
    torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)
    gt = _nchw(g, torch.float32)
    got = torch.autograd.grad((y * gt).sum(), (xt, mod.weight, mod.bias))
    want = torch.autograd.grad((ref * gt).sum(), (xt, mod.weight, mod.bias))
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-5)


def test_nafblock_plain_versions_share_the_ln_math():
    assert nafblock._ln_stats is ln.ln_stats
    assert nafblock._ln_bwd is ln.ln_input_grad


def test_cpu_calls_count_no_launch():
    x, g, w, b = _data((1, 4, 4, 8))
    ln.call_ln_fwd.launches = ln.call_ln_bwd.launches = 0
    xt = _nchw(x, torch.float32).flatten(2)
    y, xhat, rstd = ln.call_ln_fwd(xt, torch.from_numpy(w),
                                   torch.from_numpy(b))
    ln.call_ln_bwd(_nchw(g, torch.float32).flatten(2), xhat, rstd,
                   torch.from_numpy(w))
    assert ln.call_ln_fwd.launches == 0 and ln.call_ln_bwd.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "channels", "strided", "rank",
                                 "weight"])
def test_kernel_input_checks_raise(bad):
    """What the CUDA wrappers refuse (the checks run before any launch)."""
    x = torch.zeros(1, 8, 16)
    w = torch.ones(8)
    if bad == "dtype":
        with pytest.raises(TypeError, match="fp32 or bf16"):
            ln._check_activation(x.half(), "x")
    elif bad == "channels":
        with pytest.raises(ValueError, match="C <= 1024"):
            ln._check_activation(torch.zeros(1, 1025, 2), "x")
    elif bad == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            ln._check_activation(x.transpose(1, 2), "x")
    elif bad == "rank":
        with pytest.raises(ValueError, match=r"\[N, C, H\*W\]"):
            ln._check_activation(torch.zeros(1, 8, 4, 4), "x")
    else:
        with pytest.raises(ValueError, match="entries"):
            ln._vector(torch.ones(7), x, "weight")
        assert ln._vector(w.double(), x, "weight").dtype == torch.float32
