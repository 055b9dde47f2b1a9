"""The port's fused relu + 2x2 max pool (the plain versions of kernels
K7/K8), ``max_pool_2x2`` and the VGG19 trunk's pool options held against
the JAX package.

References: ``ops/pallas/pool.py`` in interpret mode (shapes its
``supported()`` takes) and ``max_pool_2x2`` under
``LLIE_MAXPOOL_IMPL=pallas_bwd``. Pooling moves values and gradients
without arithmetic, so every pool comparison is exact, NaNs included
(a NaN equals a NaN here). The trunk and ``PerceptualLoss`` go through
convolutions: rtol 1e-4 with atol 1e-4 of the gradient's largest entry,
the tolerance of ``tests/test_torch_port_losses.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.losses import components as jcomp
from lowlight_image_enhancement_tpu.ops import image_ops as jimage_ops
from lowlight_image_enhancement_tpu.ops.pallas import pool as jpool
from lowlight_image_enhancement_tpu_torch.losses import components
from lowlight_image_enhancement_tpu_torch.models.vgg import VGG19Features
from lowlight_image_enhancement_tpu_torch.ops import image_ops, pool
from lowlight_image_enhancement_tpu_torch.training.trainer import (
    build_hybrid_loss,
)
from lowlight_image_enhancement_tpu_torch.weights import vgg_params_from_jax

SHAPE = (2, 8, 16, 64)          # NHWC, taken by the Pallas kernels
CASES = ["random", "ties", "all_negative", "nan"]
POOL_IMPLS = ["reduce_window", "kernel_bwd", "kernel_fused"]


def _case(name, shape=SHAPE, seed=0):
    """NHWC input x and cotangent dy."""
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    if name == "random":
        x = rng.standard_normal(shape)
    elif name == "ties":        # a handful of values: most windows tie
        x = rng.choice([-1.0, -0.0, 0.0, 0.5, 2.0], size=shape)
    elif name == "all_negative":
        x = -np.abs(rng.standard_normal(shape)) - 0.1
    else:
        x = rng.standard_normal(shape)
        x[rng.uniform(size=shape) < 0.1] = np.nan
    dy = rng.standard_normal((n, h // 2, w // 2, c))
    return x.astype(np.float32), dy.astype(np.float32)


def _nchw(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2))).to(dt)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _same(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    ok = (got == ref) | (np.isnan(got) & np.isnan(ref))
    assert ok.all(), f"{what}: {int((~ok).sum())} entries differ"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_relu_max_pool_matches_pallas(case, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x, dy = _case(case)
    assert jpool.supported(x.shape)
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    y_j, vjp = jax.vjp(jpool.relu_max_pool_2x2, xj)
    (dx_j,) = vjp(dyj)

    xt = _nchw(x, tdt).requires_grad_(True)
    y = pool.relu_max_pool_2x2(xt)
    (dx,) = torch.autograd.grad(y, xt, _nchw(dy, tdt))
    assert y.dtype == dx.dtype == tdt
    _same(_nhwc(y), y_j.astype(jnp.float32), "y")
    _same(_nhwc(dx), dx_j.astype(jnp.float32), "dx")
    # the plain versions are what the Function ran on the CPU
    _same(_nhwc(pool.plain_relu_pool_fwd(xt.detach())),
          y_j.astype(jnp.float32), "plain fwd")
    _same(_nhwc(pool.plain_pool_bwd(xt.detach(), _nchw(dy, tdt), True)),
          dx_j.astype(jnp.float32), "plain bwd")


@pytest.mark.parametrize("case", CASES)
def test_max_pool_bwd_without_relu_matches_pallas(case):
    x, dy = _case(case, seed=1)
    dx_j = jpool.max_pool_2x2_bwd(jnp.asarray(x), jnp.asarray(dy))
    dx = pool.max_pool_2x2_bwd(_nchw(x), _nchw(dy))
    _same(_nhwc(dx), dx_j, "dx")
    if case != "nan":
        # gradient mass is conserved window by window (no relu mask)
        np.testing.assert_allclose(
            _nhwc(dx).reshape(2, 4, 2, 8, 2, 64).sum((2, 4)), dy, rtol=0,
            atol=0)


@pytest.mark.parametrize("spelling", ["kernel_bwd", "pallas_bwd", "env"])
@pytest.mark.parametrize("shape", [SHAPE, (2, 9, 17, 64)])
def test_max_pool_kernel_bwd_matches_jax_option(shape, spelling, monkeypatch):
    """An odd H and W is floored away on both sides; the dropped row and
    column get a zero gradient."""
    monkeypatch.setenv("LLIE_MAXPOOL_IMPL", "pallas_bwd")
    x, dy = _case("ties", shape, seed=2)
    y_j, vjp = jax.vjp(jimage_ops.max_pool_2x2, jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(dy))

    xt = _nchw(x).requires_grad_(True)
    y = image_ops.max_pool_2x2(xt, None if spelling == "env" else spelling)
    assert type(y.grad_fn).__name__ == "_MaxPoolKernelBwdBackward"
    (dx,) = torch.autograd.grad(y, xt, _nchw(dy))
    _same(_nhwc(y), y_j, "y")
    _same(_nhwc(dx), dx_j, "dx")
    if shape[1] % 2:
        assert not dx[:, :, -1].any() and not dx[:, :, :, -1].any()
    # the default option gives the same value and gradient
    monkeypatch.delenv("LLIE_MAXPOOL_IMPL")
    y0 = image_ops.max_pool_2x2(xt)
    assert type(y0.grad_fn).__name__ != "_MaxPoolKernelBwdBackward"
    (dx0,) = torch.autograd.grad(y0, xt, _nchw(dy))
    assert torch.equal(y0, y) and torch.equal(dx0, dx)


def test_relu_max_pool_odd_size_and_nan_remainder():
    x = torch.tensor([[[[float("nan"), 1.0, 5.0],
                        [2.0, -3.0, 5.0],
                        [7.0, 7.0, 7.0]]]], requires_grad=True)
    y = pool.relu_max_pool_2x2(x)
    assert y.shape == (1, 1, 1, 1) and torch.isnan(y).all()
    (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    # a NaN max routes to (1,1), where x <= 0 masks it; nothing elsewhere
    assert not dx.any()
    dx = pool.max_pool_2x2_bwd(x.detach(), torch.ones(1, 1, 1, 1))
    want = torch.zeros(1, 1, 3, 3)
    want[0, 0, 1, 1] = 1.0
    assert torch.equal(dx, want)


def test_unknown_pool_option_raises(monkeypatch):
    x = torch.zeros(1, 1, 2, 2)
    with pytest.raises(ValueError, match="max-pool implementation"):
        image_ops.max_pool_2x2(x, "kernel_fused")
    monkeypatch.setenv("LLIE_MAXPOOL_IMPL", "slice")
    with pytest.raises(ValueError, match="max-pool implementation"):
        image_ops.max_pool_2x2(x)
    with pytest.raises(ValueError, match="pool_impl"):
        VGG19Features(pool_impl="cmp")


def test_pixel_unshuffle_matches_jax_and_inverts_pixel_shuffle():
    x = np.random.default_rng(4).standard_normal((2, 6, 8, 3)).astype(
        np.float32)
    ref = np.asarray(jimage_ops.pixel_unshuffle(jnp.asarray(x), 2))
    got = image_ops.pixel_unshuffle(_nchw(x), 2)
    np.testing.assert_array_equal(_nhwc(got), ref)
    assert torch.equal(torch.nn.functional.pixel_shuffle(got, 2), _nchw(x))
    with pytest.raises(ValueError, match="not divisible"):
        image_ops.pixel_unshuffle(torch.zeros(1, 1, 3, 4), 2)


@pytest.fixture(scope="module")
def trunk_pair():
    """The JAX random trunk (taps relu2_2 and relu5_4: one pool follows a
    tapped relu, three are ``relu(pool(x))`` sites) and its weights."""
    jperc = jcomp.PerceptualLoss(taps=("relu2_2", "relu5_4"))
    sd = vgg_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jperc.variables["params"]))
    rng = np.random.default_rng(7)
    gt = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    pred = (gt + rng.normal(0, 0.2, gt.shape)).astype(np.float32)
    return jperc, sd, pred, gt


@pytest.mark.parametrize("impl", POOL_IMPLS)
def test_perceptual_loss_under_each_pool_option(trunk_pair, impl):
    jperc, sd, pred, gt = trunk_pair
    jval, jgrad = jax.value_and_grad(lambda p: jperc(p, jnp.asarray(gt)))(
        jnp.asarray(pred))
    perc = components.PerceptualLoss(taps=("relu2_2", "relu5_4"),
                                     pool_impl=impl)
    perc.vgg.load_state_dict(sd)
    pt = _nchw(pred).requires_grad_(True)
    val = perc(pt, _nchw(gt))
    (grad,) = torch.autograd.grad(val, pt)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-4,
                               atol=0)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(_nhwc(grad), jgrad, rtol=1e-4,
                               atol=1e-4 * float(np.abs(jgrad).max()))


def test_trunk_is_identical_under_the_pool_options(trunk_pair):
    _, sd, pred, _ = trunk_pair
    outs = {}
    for impl in POOL_IMPLS:
        vgg = VGG19Features(taps=("relu2_2", "relu5_4"), pool_impl=impl)
        vgg.load_state_dict(sd)
        pool.call_pool_bwd.launches = 0
        pt = _nchw(pred).requires_grad_(True)
        feats = vgg(pt)
        (g,) = torch.autograd.grad(sum(f.square().sum()
                                       for f in feats.values()), pt)
        outs[impl] = (feats, g)
        assert pool.call_pool_bwd.launches == 0      # CPU: plain versions
    ref_feats, ref_g = outs["reduce_window"]
    for impl in POOL_IMPLS[1:]:
        feats, g = outs[impl]
        for k in ref_feats:
            assert torch.equal(feats[k], ref_feats[k]), (impl, k)
        assert torch.equal(g, ref_g), impl


def test_build_hybrid_loss_passes_the_pool_option():
    opt = {"hybrid_opt": {"type": "HybridLossPlus", "pretrained": False,
                          "use_phys": False,
                          "perceptual": {"pool_impl": "kernel_fused"}}}
    loss = build_hybrid_loss(opt, device="cpu")
    assert loss.perceptual.vgg.pool_impl == "kernel_fused"
    del opt["hybrid_opt"]["perceptual"]
    assert build_hybrid_loss(opt, device="cpu").perceptual.vgg.pool_impl \
        is None
