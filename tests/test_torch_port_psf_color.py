"""The port's PSF operator, colour science and max pool held against the
JAX package (fp32, inputs from numpy, NCHW in the port vs NHWC in JAX).

Tolerances: 1e-6 for the PSF kernels and convolutions (fp32 sums of a
few O(1) products in another order), rtol 1e-4 for Lab and CIEDE2000
(transcendentals computed by two libraries), exact equality where both sides compute the same
operation on the same floats (kernels, max-pool values and routing).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.ops import color as jcolor
from lowlight_image_enhancement_tpu.ops import psf as jpsf
from lowlight_image_enhancement_tpu.ops.image_ops import (
    max_pool_2x2 as jax_max_pool_2x2,
)
from lowlight_image_enhancement_tpu_torch.ops import color, psf
from lowlight_image_enhancement_tpu_torch.ops.image_ops import max_pool_2x2

DATA = Path(__file__).resolve().parent / "data"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode,spec", [("mono", "P2"), ("rgb", "B2")])
def test_psf_kernels_and_normalisation(mode, spec):
    k = psf.build_psf_kernels(mode, spec)
    np.testing.assert_array_equal(k.numpy(),
                                  np.asarray(jpsf.build_psf_kernels(mode, spec)))
    kn = psf.normalize_psf_energy(k)
    np.testing.assert_allclose(
        kn.numpy(), np.asarray(jpsf.normalize_psf_energy(
            jpsf.build_psf_kernels(mode, spec))), rtol=1e-6, atol=0)
    np.testing.assert_allclose(kn.sum((1, 2)).numpy(), 1.0, rtol=1e-6)
    mod = psf.create_crosstalk_psf(mode)
    assert not list(mod.parameters()) and "kernel" in dict(mod.named_buffers())
    torch.testing.assert_close(mod.kernel, kn)
    with pytest.raises(ValueError):
        psf.build_psf_kernels(mode, "B2" if spec == "P2" else "P2")


@pytest.mark.parametrize("padding", ["zero", "replicate", "reflect"])
@pytest.mark.parametrize("kshape", [(1, 3, 3), (3, 3, 3), (1, 1, 5)])
def test_depthwise_conv_matches_jax(padding, kshape):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    k = rng.normal(size=kshape).astype(np.float32)
    ref = np.asarray(jpsf.depthwise_conv(jnp.asarray(x), jnp.asarray(k),
                                         padding=padding))
    got = psf.depthwise_conv(_nchw(x), torch.from_numpy(k), padding=padding)
    np.testing.assert_allclose(_nhwc(got), ref, atol=1e-6, rtol=1e-6)


def test_newbp_conv_adjoint_and_crosstalk_psf():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 3, 8, 10)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    k = psf.normalize_psf_energy(psf.build_psf_kernels("rgb", "B2"))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = psf.newbp_conv(xt, k)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy))
    # the explicit adjoint equals autograd of the zero-padded conv
    xa = torch.from_numpy(x).requires_grad_(True)
    ya = psf.depthwise_conv(xa, k, padding="zero")
    (ga,) = torch.autograd.grad(ya, xa, torch.from_numpy(gy))
    torch.testing.assert_close(y, ya)
    torch.testing.assert_close(gx, ga, atol=1e-6, rtol=1e-6)
    # <g, K x> == <K^T g, x>
    lhs = float((torch.from_numpy(gy) * y.detach()).sum())
    rhs = float((gx * xt.detach()).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)
    # the module: same conv as JAX, kernel gets no grad
    mod = psf.create_crosstalk_psf("rgb")
    jmod = jpsf.create_crosstalk_psf("rgb")
    ref = np.asarray(jmod(jnp.asarray(x.transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(_nhwc(mod(torch.from_numpy(x))), ref,
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        mod(torch.zeros(1, 4, 5, 5))


@pytest.fixture(scope="module")
def rgb_pair():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (2, 6, 7, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    a[0, 0, 0] = 0.5      # a gray pixel (zero chroma)
    b[0, 0, 0] = 0.5
    return a, b


def test_srgb_lab_match_jax(rgb_pair):
    a, _ = rgb_pair
    np.testing.assert_allclose(
        _nhwc(color.srgb_to_linear(_nchw(a))),
        np.asarray(jcolor.srgb_to_linear(jnp.asarray(a))), rtol=1e-5,
        atol=1e-7)
    np.testing.assert_allclose(
        _nhwc(color.linear_to_srgb(_nchw(a))),
        np.asarray(jcolor.linear_to_srgb(jnp.asarray(a))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        _nhwc(color.rgb_to_lab(_nchw(a))),
        np.asarray(jcolor.rgb_to_lab(jnp.asarray(a))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("formula", ["sharma", "reference_loss"])
def test_deltae2000_value_and_grad_match_jax(rgb_pair, formula):
    a, b = rgb_pair
    ref = np.asarray(jcolor.deltaE2000_rgb(jnp.asarray(a), jnp.asarray(b),
                                           formula=formula))
    jgrad = np.asarray(jax.grad(lambda u: jnp.sum(jcolor.deltaE2000_rgb(
        u, jnp.asarray(b), formula=formula)))(jnp.asarray(a)))
    at = _nchw(a).requires_grad_(True)
    got = color.deltaE2000_rgb(at, _nchw(b), formula=formula)
    (g,) = torch.autograd.grad(got.sum(), at)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(_nhwc(g), jgrad, rtol=1e-3,
                               atol=1e-3 * np.abs(jgrad).max())


def test_ciede2000_gold_pairs():
    pairs = json.loads((DATA / "ciede2000_pairs.json").read_text())
    lab1 = torch.tensor([[p["L1"], p["a1"], p["b1"]] for p in pairs])
    lab2 = torch.tensor([[p["L2"], p["a2"], p["b2"]] for p in pairs])
    want = np.asarray([p["de00"] for p in pairs])
    got = color.ciede2000_lab(lab1, lab2).numpy()
    # the first 16 are Sharma's published values; the last 2 synthetic
    # out-of-gamut probes (as the JAX package's own gold test treats them)
    np.testing.assert_allclose(got[:16], want[:16], atol=2e-3)
    np.testing.assert_allclose(got[16:], want[16:], atol=1.5)
    ref = np.asarray(jcolor.ciede2000_lab(jnp.asarray(lab1.numpy()),
                                          jnp.asarray(lab2.numpy())))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    ref_loss = np.asarray(jcolor.ciede2000_lab_ref_loss(
        jnp.asarray(lab1.numpy()), jnp.asarray(lab2.numpy())))
    np.testing.assert_allclose(
        color.ciede2000_lab_ref_loss(lab1, lab2).numpy(), ref_loss,
        rtol=1e-5, atol=1e-5)


def test_sobel_magnitude_matches_jax():
    x = np.random.default_rng(4).uniform(0, 100, (2, 9, 8)).astype(np.float32)
    ref = np.asarray(jcolor.sobel_magnitude(jnp.asarray(x)))
    got = color.sobel_magnitude(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 8, 10, 3), (1, 7, 9, 4)],
                         ids=["even", "odd"])
def test_max_pool_value_and_tie_routing_match_jax(shape):
    rng = np.random.default_rng(5)
    # few distinct values: most windows hold ties
    x = rng.integers(0, 3, shape).astype(np.float32)
    gy_shape = (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    gy = rng.normal(size=gy_shape).astype(np.float32)
    ref = np.asarray(jax_max_pool_2x2(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda u: jnp.sum(
        jax_max_pool_2x2(u) * jnp.asarray(gy)))(jnp.asarray(x)))
    xt = _nchw(x).requires_grad_(True)
    y = max_pool_2x2(xt)
    (g,) = torch.autograd.grad(y, xt, _nchw(gy))
    np.testing.assert_array_equal(_nhwc(y), ref)
    np.testing.assert_array_equal(_nhwc(g), jgrad)
