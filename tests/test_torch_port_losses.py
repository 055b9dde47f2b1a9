"""The port's loss stack held against the JAX package: each component and
``HybridLossPlus`` (the self-contained flagship settings, the JAX random
VGG19 trunk bridged with ``vgg_params_from_jax``), value and gradient
with respect to the prediction, fp32, rtol 1e-4 (atol 1e-4 of the
gradient's largest entry: conv and transcendental sums in another
order); and ``psnr_linear`` / ``ssim_linear``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lowlight_image_enhancement_tpu.losses import components as jcomp
from lowlight_image_enhancement_tpu.metrics import linear as jlinear
from lowlight_image_enhancement_tpu.ops.psf import (
    build_psf_kernels as jbuild_psf_kernels,
)
from lowlight_image_enhancement_tpu.ops.psf import (
    create_crosstalk_psf as jcreate_crosstalk_psf,
)
from lowlight_image_enhancement_tpu.ops.psf import (
    normalize_psf_energy as jnormalize_psf_energy,
)
from lowlight_image_enhancement_tpu.training import train_step as jts
from lowlight_image_enhancement_tpu.training.trainer import (
    build_hybrid_loss as jbuild_hybrid_loss,
)
from lowlight_image_enhancement_tpu_torch import losses
from lowlight_image_enhancement_tpu_torch.losses import components
from lowlight_image_enhancement_tpu_torch.metrics import linear
from lowlight_image_enhancement_tpu_torch.ops import psf
from lowlight_image_enhancement_tpu_torch.training import train_step as ts
from lowlight_image_enhancement_tpu_torch.training.trainer import (
    build_hybrid_loss,
)
from lowlight_image_enhancement_tpu_torch.weights import vgg_params_from_jax

RTOL = 1e-4
CONFIG = "configs/sid_newbp_mono_selfcontained.yml"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    expo = np.array([100.0, 300.0], np.float32)
    lq = np.clip(gt / expo[:, None, None, None]
                 + rng.normal(0, 1e-3, gt.shape), 0, 1).astype(np.float32)
    # a prediction that leaves [0, 1] in places (exercises the clamps)
    pred = (gt + rng.normal(0, 0.2, gt.shape)).astype(np.float32)
    return dict(gt=gt, lq=lq, expo=expo, pred=pred)


@pytest.fixture(scope="module")
def vgg_pair():
    """The JAX random trunk and the port's trunk loaded with it."""
    jperc = jcomp.PerceptualLoss()
    perc = components.PerceptualLoss()
    perc.vgg.load_state_dict(vgg_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jperc.variables["params"])))
    return jperc, perc


def _compare(jfn, fn, pred):
    """Value and d/d pred of a scalar loss on both sides."""
    jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred))
    pt = _nchw(pred).requires_grad_(True)
    val = fn(pt)
    (grad,) = torch.autograd.grad(val, pt)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=RTOL,
                               atol=0)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(_nhwc(grad), jgrad, rtol=RTOL,
                               atol=1e-4 * float(np.abs(jgrad).max()))


def test_perceptual_loss(data, vgg_pair):
    jperc, perc = vgg_pair
    gt = data["gt"]
    _compare(lambda p: jperc(p, jnp.asarray(gt)),
             lambda p: perc(p, _nchw(gt)), data["pred"])


def test_target_branch_builds_no_graph(vgg_pair, data):
    _, perc = vgg_pair
    gt = _nchw(data["gt"]).requires_grad_(True)
    pred = _nchw(data["pred"]).requires_grad_(True)
    perc(pred, gt).backward()
    assert gt.grad is None and pred.grad is not None


@pytest.mark.parametrize("name", ["ssim", "deltaE_ref", "deltaE_sharma",
                                  "phys_raw", "phys_srgb"])
def test_components(data, name):
    gt, lq, expo = data["gt"], data["lq"], data["expo"]
    k = jnormalize_psf_energy(jbuild_psf_kernels("mono", "P2"))
    if name == "ssim":
        j, t = jcomp.SSIMLoss(), components.SSIMLoss()
        jfn = lambda p: j(p, jnp.asarray(gt))
        fn = lambda p: t(p, _nchw(gt))
    elif name.startswith("deltaE"):
        formula = "reference_loss" if name == "deltaE_ref" else "sharma"
        j = jcomp.DeltaE00Loss(formula=formula)
        t = components.DeltaE00Loss(formula=formula)
        jfn = lambda p: j(p, jnp.asarray(gt))
        fn = lambda p: t(p, _nchw(gt))
    elif name == "phys_raw":
        j = jcomp.PhysicsConsistencyLoss(k)
        t = components.PhysicsConsistencyLoss(torch.from_numpy(np.array(k)))
        jfn = lambda p: j(p, jnp.asarray(lq), jnp.asarray(expo))
        fn = lambda p: t(p, _nchw(lq), torch.from_numpy(expo))
    else:
        j = jcomp.PhysicalConsistencyLossSRGB(jcreate_crosstalk_psf("mono"))
        t = components.PhysicalConsistencyLossSRGB(
            psf.create_crosstalk_psf("mono"))
        jfn = lambda p: j(p, jnp.asarray(lq), jnp.asarray(expo))
        fn = lambda p: t(p, _nchw(lq), torch.from_numpy(expo))
    _compare(jfn, fn, data["pred"])


def test_align_exposure_srgb_scales_a(data):
    lq, expo = data["lq"], data["expo"]
    ref = np.asarray(jcomp.align_exposure_srgb(jnp.asarray(lq),
                                               jnp.asarray(expo)))
    got = components.align_exposure_srgb(_nchw(lq), torch.from_numpy(expo))
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-6)
    assert float(got.max()) == 1.0   # rho = 100, 300 saturates


def _hybrid_pair(vgg_pair, **overrides):
    opt = yaml.safe_load(open(CONFIG))["train"]
    opt["enable_amp"] = False          # fp32 perceptual trunk on both sides
    opt["hybrid_opt"] = {**opt["hybrid_opt"], **overrides}
    jloss = jbuild_hybrid_loss(opt)
    loss = build_hybrid_loss(opt, device="cpu")
    jloss.perceptual = vgg_pair[0]
    loss.perceptual = vgg_pair[1]
    return jloss, loss


@pytest.mark.parametrize("variant", ["flagship", "ssim_uncertainty",
                                     "raw_physics"])
def test_hybrid_loss_plus_matches_jax(data, vgg_pair, variant):
    overrides = {}
    if variant == "ssim_uncertainty":
        overrides = dict(use_ssim=True, w_ssim=0.05, use_uncertainty=True)
    elif variant == "raw_physics":
        overrides = dict(physics={"mode": "mono", "kernel_spec": "P2",
                                  "domain": "raw"})
    jloss, loss = _hybrid_pair(vgg_pair, **overrides)
    assert loss.use == jloss.use and loss.w == jloss.w
    jlog_sigma = None
    if variant == "ssim_uncertainty":
        vals = {k: 0.1 * (i + 1) for i, k in
                enumerate(jloss.init_uncertainty_params())}
        assert set(vals) == set(loss.log_sigma)
        jlog_sigma = {k: jnp.asarray(v, jnp.float32) for k, v in vals.items()}
        with torch.no_grad():
            for k, v in vals.items():
                loss.log_sigma[k].fill_(v)
    gt, lq, expo = data["gt"], data["lq"], data["expo"]
    jbatch = dict(gt=jnp.asarray(gt), lq=jnp.asarray(lq),
                  expo_ratio=jnp.asarray(expo))
    batch = dict(gt=_nchw(gt), lq=_nchw(lq), expo_ratio=torch.from_numpy(expo))

    def jfn(p):
        return jloss(**jts.hybrid_batch_kwargs(p, jbatch),
                     log_sigma=jlog_sigma)

    def fn(p):
        return loss(**ts.hybrid_batch_kwargs(p, batch),
                    log_sigma=loss.log_sigma or None)

    jtotal, jlogs = jfn(jnp.asarray(data["pred"]))
    total, logs = fn(_nchw(data["pred"]))
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=RTOL, atol=1e-8, err_msg=k)
        assert not logs[k].requires_grad
    _compare(lambda p: jfn(p)[0], lambda p: fn(p)[0], data["pred"])


def test_hybrid_loss_rules():
    with pytest.raises(ValueError, match="exactly one"):
        losses.HybridLossPlus(use_perc=False)
    with pytest.raises(NotImplementedError, match="metrics slice"):
        losses.HybridLossPlus(use_perc=False, use_lpips=True,
                              physics_psf_module=psf.create_crosstalk_psf())
    with pytest.raises(FloatingPointError):
        losses.assert_finite_logs({"a": torch.tensor(1.0),
                                   "b": torch.tensor(float("nan"))})
    losses.assert_finite_logs({"a": torch.tensor(1.0)})
    l1 = losses.build_loss({"type": "L1Loss", "loss_weight": 2.0})
    a, b = torch.ones(1, 3, 4, 4), torch.zeros(1, 3, 4, 4)
    assert float(l1(a, b)) == 2.0


@pytest.mark.parametrize("kw", [dict(), dict(clamp=True, reduction="none"),
                                dict(data_range=2.0, reduction="sum")])
def test_psnr_linear_matches_jax(data, kw):
    pred, gt = data["pred"], data["gt"]
    ref = np.asarray(jlinear.psnr_linear(jnp.asarray(pred), jnp.asarray(gt),
                                         **kw))
    got = linear.psnr_linear(_nchw(pred), _nchw(gt), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    same = linear.psnr_linear(_nchw(gt), _nchw(gt), reduction="none")
    assert torch.isinf(same).all()


@pytest.mark.parametrize("kw", [dict(), dict(padding="replicate",
                                             per_channel=True,
                                             reduction="none"),
                                dict(padding="zero", gaussian=False,
                                     kernel_size=7)])
def test_ssim_linear_matches_jax(data, kw):
    pred, gt = np.clip(data["pred"], 0, 1), data["gt"]
    ref = np.asarray(jlinear.ssim_linear(jnp.asarray(pred), jnp.asarray(gt),
                                         **kw))
    got = linear.ssim_linear(_nchw(pred), _nchw(gt), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("corrupt", ["missing", "unknown", "extra_leaf"])
def test_vgg_bridge_rejects_bad_trees(vgg_pair, corrupt):
    tree = jax.tree_util.tree_map(np.asarray,
                                  vgg_pair[0].variables["params"])
    tree = {k: dict(v) for k, v in tree.items()}
    if corrupt == "missing":
        del tree["conv5_4"]
    elif corrupt == "unknown":
        tree["conv6_1"] = tree["conv5_4"]
    else:
        tree["conv1_1"]["scale"] = tree["conv1_1"]["bias"]
    with pytest.raises(KeyError):
        vgg_params_from_jax(tree)
