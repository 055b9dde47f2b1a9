"""The port's LPIPS against the JAX package's, on the CPU, fp32 (rtol
1e-4), with the JAX networks' weights carried over by
``weights.lpips_params_from_jax``:

- ``models/lpips.py:LPIPSNet`` (alex and vgg, spatial on and off) at
  2x3x64^2 and 1x3x48x40;
- ``metrics/lpips_metric.py`` (``LPIPSMetric.per_image`` / ``evaluate``
  under the ``center_crop`` and ``resize`` policies, inputs in [0, 255],
  [0, 1] and [-1, 1], the std of the scores to 1e-4 of the largest
  score; ``LPIPSEvaluator``; ``evaluate_pairs``) and
  ``metrics/perceptual.py:lpips_srgb``;
- a synthetic ``.npz`` written to ``tmp_path`` and read by both loaders;
- ``HybridLossPlus(use_lpips=True)``: its ``l_lpips`` and the gradients of
  a debug-size network through the whole loss (1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.losses.hybrid import (
    HybridLossPlus as JHybrid,
)
from lowlight_image_enhancement_tpu.metrics import lpips_metric as jlm
from lowlight_image_enhancement_tpu.metrics import perceptual as jperc
from lowlight_image_enhancement_tpu.models.lpips import LPIPSNet as JLPIPSNet
from lowlight_image_enhancement_tpu.models.lpips import load_lpips as jload
from lowlight_image_enhancement_tpu.models.nafnet import NAFNet as JaxNAFNet
from lowlight_image_enhancement_tpu.ops.psf import (
    create_crosstalk_psf as jpsf,
)
from lowlight_image_enhancement_tpu.training.train_step import (
    hybrid_batch_kwargs as jax_batch_kwargs,
)
from lowlight_image_enhancement_tpu_torch.losses.hybrid import HybridLossPlus
from lowlight_image_enhancement_tpu_torch.metrics import lpips_metric
from lowlight_image_enhancement_tpu_torch.metrics import perceptual
from lowlight_image_enhancement_tpu_torch.models.lpips import (
    LPIPSNet,
    load_lpips,
)
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFNet
from lowlight_image_enhancement_tpu_torch.ops.psf import create_crosstalk_psf
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    hybrid_batch_kwargs,
)
from lowlight_image_enhancement_tpu_torch.weights import (
    lpips_params_from_jax,
    params_from_jax,
)

RTOL = 1e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                             (0, 3, 1, 2))))


@pytest.fixture(scope="module")
def jax_lpips():
    """``{(net, spatial): (module, numpy variables)}`` of the JAX package,
    its heads redrawn from U[0, 0.2) so that no head is near 0."""
    out = {}
    for net in ("alex", "vgg"):
        module, variables, pretrained = jload(net=net)
        assert not pretrained
        params = dict(jax.tree_util.tree_map(np.asarray,
                                             variables)["params"])
        rng = np.random.default_rng(0)
        for k in params:
            if k.startswith("lin"):
                params[k] = rng.uniform(0, 0.2, params[k].shape).astype(
                    np.float32)
        out[net, False] = (module, {"params": params})
        out[net, True] = (JLPIPSNet(net=net, spatial=True),
                          {"params": params})
    return out


def _port(jax_lpips, net, spatial=False):
    module = LPIPSNet(net=net, spatial=spatial)
    module.load_state_dict(lpips_params_from_jax(
        jax_lpips[net, spatial][1], net))
    return module


def _jax_apply(jax_lpips, net, spatial, x, y):
    module, variables = jax_lpips[net, spatial]
    return np.asarray(module.apply(variables, jnp.asarray(x),
                                   jnp.asarray(y)))


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 48, 40, 3)])
@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_net_matches_jax(jax_lpips, net, spatial, shape):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, shape), -1, 1).astype(np.float32)
    want = _jax_apply(jax_lpips, net, spatial, x, y)
    with torch.no_grad():
        got = _port(jax_lpips, net, spatial)(_nchw(x), _nchw(y)).numpy()
    assert got.shape == want.shape == ((shape[0],) if not spatial
                                       else shape[:3])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(
        want).max())


def _metric_pair(seed, lo, hi, shape_p=(2, 40, 36, 3), shape_t=(2, 32, 44,
                                                                   3)):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, shape_p)
    t = rng.uniform(0, 1, shape_t)
    return ((lo + (hi - lo) * p).astype(np.float32),
            (lo + (hi - lo) * t).astype(np.float32))


@pytest.fixture
def same_weights(jax_lpips, monkeypatch):
    """Both packages' metric caches hold the same LPIPS-alex network."""
    module, variables = jax_lpips["alex", False]
    apply = jax.jit(lambda a, b: module.apply(variables, a, b))
    monkeypatch.setattr(jlm.LPIPSMetric, "_CACHE",
                        {"alex:None": (apply, False)})
    monkeypatch.setattr(jperc, "_LPIPS_CACHE", {
        f"alex:{s}": (jax.jit(lambda a, b, s=s: jax_lpips["alex", s][0].apply(
            jax_lpips["alex", s][1], a, b)), False) for s in (False, True)})
    monkeypatch.setattr(lpips_metric, "_CACHE", {
        ("alex", s, None, "cpu"): (_port(jax_lpips, "alex", s), False)
        for s in (False, True)})


@pytest.mark.parametrize("lo,hi", [(0.0, 255.0), (0.0, 1.0), (-1.0, 1.0)])
@pytest.mark.parametrize("policy", ["center_crop", "resize"])
def test_lpips_metric_matches_jax(same_weights, policy, lo, hi):
    p, t = _metric_pair(2, lo, hi)
    metric = lpips_metric.LPIPSMetric(align_policy=policy, device="cpu")
    jmetric = jlm.LPIPSMetric(align_policy=policy)
    np.testing.assert_allclose(metric.per_image(_nchw(p), _nchw(t)),
                               jmetric.per_image(p, t), rtol=RTOL)
    got, want = metric.evaluate(_nchw(p), _nchw(t)), jmetric.evaluate(p, t)
    assert got["config"] == want["config"]
    assert got["config"]["pretrained"] is False
    for k in ("lpips_mean", "per_image"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)
    # the std of two scores is half their difference: held to 1e-4 of the
    # scores, not of itself
    np.testing.assert_allclose(got["lpips_std"], want["lpips_std"], rtol=0,
                               atol=RTOL * max(want["per_image"]))


def test_lpips_metric_apis_and_checks(same_weights):
    p, t = _metric_pair(3, 0.0, 1.0, (2, 32, 32, 1), (2, 32, 32, 1))
    np.testing.assert_allclose(  # gray promoted to RGB
        lpips_metric.LPIPSEvaluator(device="cpu")(_nchw(p), _nchw(t)),
        jlm.LPIPSEvaluator()(p, t), rtol=RTOL)
    got = lpips_metric.evaluate_pairs([(_nchw(p), _nchw(t))] * 2,
                                      device="cpu")
    want = jlm.evaluate_pairs([(p, t)] * 2)
    assert got["count"] == want["count"] == 4
    np.testing.assert_allclose(got["per_image"], want["per_image"],
                               rtol=RTOL)
    metric = lpips_metric.LPIPSMetric(device="cpu")
    with pytest.raises(ValueError, match="align_policy='error'"):
        metric.per_image(_nchw(p), _nchw(t)[:, :, :20])
    with pytest.raises(ValueError, match="16x16"):
        metric.per_image(_nchw(p)[:, :, :8], _nchw(t)[:, :, :8])
    with pytest.raises(ValueError, match="version"):
        lpips_metric.LPIPSMetric(version="0.0", device="cpu")


@pytest.mark.parametrize("spatial", [False, True])
def test_lpips_srgb_matches_jax(same_weights, spatial):
    rng = np.random.default_rng(4)
    p = rng.uniform(-0.1, 1.1, (2, 32, 40, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (2, 32, 40, 3)).astype(np.float32)
    got = perceptual.lpips_srgb(_nchw(p), _nchw(t), spatial=spatial,
                                device="cpu")
    want = np.asarray(jperc.lpips_srgb(p, t, spatial=spatial))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    with pytest.raises(ValueError, match="finite"):
        bad = _nchw(t).clone()
        bad[0, 0, 0, 0] = float("nan")
        perceptual.lpips_srgb(bad, _nchw(t), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        perceptual.lpips_srgb(_nchw(p), _nchw(t)[:, :, :16], device="cpu")


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_npz_is_read_by_both_loaders(jax_lpips, tmp_path, monkeypatch, net):
    """A converted-format file (``trunk.conv*`` OIHW, ``lin{i}.weight``
    ``[C]``) gives both packages the same network."""
    sd = lpips_params_from_jax(jax_lpips[net, False][1], net)
    rng = np.random.default_rng(5)
    arrays = {k: (rng.uniform(0, 0.3, v.shape[1]).astype(np.float32)
                  if k.startswith("lin") else v.numpy() * 1.5)
              for k, v in sd.items()}
    path = tmp_path / f"lpips_{net}.npz"
    np.savez(path, **arrays)
    module, variables, pretrained = jload(net=net, weights_path=str(path))
    port, port_pretrained = load_lpips(net=net, weights_path=str(path))
    assert pretrained and port_pretrained
    x = rng.uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    want = np.asarray(module.apply(variables, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        np.testing.assert_allclose(port(_nchw(x), _nchw(y)).numpy(), want,
                                   rtol=RTOL)
    monkeypatch.setenv("LLIE_LPIPS_NPZ", str(path))
    assert load_lpips(net=net)[1]
    monkeypatch.delenv("LLIE_LPIPS_NPZ")
    a, pa = load_lpips(net=net)
    b, _ = load_lpips(net=net)
    assert not pa and all(torch.equal(u, v) for u, v in zip(
        a.state_dict().values(), b.state_dict().values()))


KW = dict(img_channel=3, width=8, enc_blk_nums=(1, 2), middle_blk_num=1,
          dec_blk_nums=(1, 1))


def test_hybrid_loss_lpips_term_matches_jax(jax_lpips):
    """``HybridLossPlus(use_lpips=True, w_lpips=0.05)`` (L1 + LPIPS-vgg +
    the sRGB physics term) on a debug-size NAFNet: ``l_lpips`` and every
    parameter gradient against JAX, 1e-4 of each leaf's max|g|."""
    jnet = JaxNAFNet(fused_blocks=False, flat_trunk=False, **KW)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, np.shape(a))).astype(
            np.float32), params)
    gt = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    lq = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    expo = np.array([2.0, 3.0], np.float32)
    module, variables = jax_lpips["vgg", False]
    kw = dict(use_perc=False, use_deltaE=False, use_ssim=False,
              use_lpips=True, w_lpips=0.05)
    jloss = JHybrid(physics_psf_module=jpsf("mono", "P2"), **kw,
                    lpips_fn=lambda a, b: jnp.mean(module.apply(
                        variables, a * 2.0 - 1.0, b * 2.0 - 1.0)))
    jbatch = {"lq": jnp.asarray(lq), "gt": jnp.asarray(gt),
              "expo_ratio": jnp.asarray(expo)}

    def jax_total(p, b):
        out = jnet.apply({"params": p}, b["lq"])
        return jloss(**jax_batch_kwargs(out, b))

    (_, jlogs), jgrads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        params, jbatch)
    net = NAFNet(**KW)
    net.load_state_dict(params_from_jax(params, model=net))
    lpips = LPIPSNet(net="vgg")
    lpips.load_state_dict(lpips_params_from_jax(variables, "vgg"))
    loss = HybridLossPlus(physics_psf_module=create_crosstalk_psf("mono",
                                                                  "P2"),
                          lpips=lpips, **kw)
    batch = {"lq": _nchw(lq), "gt": _nchw(gt),
             "expo_ratio": torch.from_numpy(expo)}
    total, logs = loss(**hybrid_batch_kwargs(net(batch["lq"]), batch))
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=RTOL, err_msg=k)
    assert float(logs["l_lpips"]) > 0
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad(total, list(net.parameters()))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                           model=net)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=RTOL * np.abs(w).max() + 1e-12,
                                   err_msg=name)
    assert not any(p.requires_grad for p in loss.lpips.parameters())


def test_hybrid_loss_lpips_construction(monkeypatch, tmp_path):
    """The default LPIPS is vgg; ``require_pretrained`` refuses random
    features, as in JAX; ``use_uncertainty`` gives the term its own
    ``log_sigma``; bf16 inputs are cast up."""
    monkeypatch.delenv("LLIE_LPIPS_NPZ", raising=False)
    with pytest.raises(RuntimeError, match="pretrained LPIPS"):
        HybridLossPlus(use_lpips=True, use_perc=False, use_phys=False,
                       require_pretrained=True)
    loss = HybridLossPlus(use_lpips=True, use_perc=False, use_phys=False,
                          use_deltaE=False, use_ssim=False,
                          use_uncertainty=True)
    assert loss.lpips.net == "vgg" and "lpips" in loss.log_sigma
    x = torch.rand(1, 3, 32, 32)
    kw = dict(Bhat_raw=x, B_raw=x, A_raw=x, expo_ratio=1.0,
              Bhat_srgb01=x.bfloat16(), B_srgb01=(x * 0.5).bfloat16())
    total, logs = loss(**kw, log_sigma=loss.log_sigma)
    assert logs["l_lpips"].dtype == torch.float32
    assert float(logs["l_lpips"]) > 0 and torch.isfinite(total)
