"""The port's evaluation metrics against the JAX package's, on the CPU
(seeded numpy inputs; NCHW tensors for the port, NHWC for JAX):

- ``metrics/ssim.py`` (``SSIMEvaluator`` with its align, luma, window and
  data-range policies, ``SSIMMetric``, ``calculate_ssim*``,
  ``evaluate_pairs_ssim``), ``channelwise.py``, ``psnr.py``,
  ``psnr_ssim_img.py`` (``rgb2ycbcr``, the uint8 MATLAB-convention
  PSNR/SSIM): 1e-5;
- ``phys_consistency.py`` over every padding mode, PSF shape, exposure
  shape, penalty, reduction and the returned map: 1e-5;
- ``niqe.py`` with each bundled pristine model: 1e-6;
- ``evaluation.py:compute_metrics`` with a debug-size ``NewBPNAFNet``
  bridged from JAX and one LPIPS-vgg ``.npz`` for both: every key 1e-4;
- ``parameter_utils.py`` equal to JAX's count; ``flops_utils.py`` equal to
  the analytic count of the products and no larger than XLA's (which also
  counts elementwise work); ``inference_time.py``'s keys.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.metrics import channelwise as jcw
from lowlight_image_enhancement_tpu.metrics import evaluation as jev
from lowlight_image_enhancement_tpu.metrics import flops_utils as jflops
from lowlight_image_enhancement_tpu.metrics import niqe as jniqe
from lowlight_image_enhancement_tpu.metrics import parameter_utils as jpar
from lowlight_image_enhancement_tpu.metrics import phys_consistency as jphys
from lowlight_image_enhancement_tpu.metrics import psnr as jpsnr
from lowlight_image_enhancement_tpu.metrics import psnr_ssim_img as jimg
from lowlight_image_enhancement_tpu.metrics import ssim as jssim
from lowlight_image_enhancement_tpu.metrics.lpips_metric import (
    LPIPSMetric as JLPIPSMetric,
)
from lowlight_image_enhancement_tpu.models.lpips import load_lpips as jlpips
from lowlight_image_enhancement_tpu.models.nafnet import NAFNet as JaxNAFNet
from lowlight_image_enhancement_tpu_torch.metrics import (
    channelwise,
    evaluation,
    flops_utils,
    inference_time,
    niqe,
    parameter_utils,
    phys_consistency,
    psnr,
    psnr_ssim_img,
    ssim,
)
from lowlight_image_enhancement_tpu_torch.metrics import lpips_metric
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFNet
from lowlight_image_enhancement_tpu_torch.weights import (
    lpips_params_from_jax,
    params_from_jax,
)

TOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                             (0, 3, 1, 2))))


def _pair(seed, n=2, h=24, w=32, c=3, lo=0.0, hi=1.0):
    """A smooth target with edges and a noisy prediction, NHWC, in
    [lo, hi]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.tanh(8 * (xx - 0.5)), np.sin(6 * yy), xx * yy],
                    -1)[..., :c]
    gt = np.clip(0.5 + 0.4 * base[None] + rng.normal(0, 0.05, (n, h, w, c)),
                 0, 1)
    pred = np.clip(gt + rng.normal(0, 0.08, gt.shape), 0, 1)
    scale = lambda a: (lo + (hi - lo) * a).astype(np.float32)
    return scale(pred), scale(gt)


# --- SSIM family -----------------------------------------------------------

SSIM_CASES = {
    "default": (dict(), dict()),
    "luma": (dict(use_luma=True), dict()),
    "minus1_1_inferred": (dict(data_range=None), dict(lo=-1.0)),
    "uint8_range_inferred": (dict(data_range=None), dict(hi=255.0)),
    "window_clipped_8x10": (dict(), dict(h=8, w=10)),
    "uniform_replicate": (dict(gaussian=False, padding="replicate",
                               kernel_size=7), dict()),
}


@pytest.mark.parametrize("case", sorted(SSIM_CASES))
def test_ssim_evaluator_matches_jax(case):
    kw, data = SSIM_CASES[case]
    kw = {"data_range": 1.0, **kw}
    pred, gt = _pair(0, **data)
    got = ssim.SSIMEvaluator(**kw).evaluate(_nchw(pred), _nchw(gt))
    want = jssim.SSIMEvaluator(**kw).evaluate(pred, gt)
    assert got["config"] == want["config"]
    np.testing.assert_allclose(got["per_image"], want["per_image"],
                               rtol=TOL, atol=TOL)
    for k in ("ssim_mean", "ssim_std", "ssim_p50", "ssim_p95"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("policy", ["center_crop", "resize"])
def test_ssim_align_policies_match_jax(policy):
    pred, _ = _pair(1, h=40, w=36)
    _, gt = _pair(2, h=32, w=44)
    got = ssim.SSIMEvaluator(align_policy=policy).per_image(_nchw(pred),
                                                           _nchw(gt))
    want = jssim.SSIMEvaluator(align_policy=policy).per_image(pred, gt)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="align_policy='error'"):
        ssim.SSIMEvaluator().per_image(_nchw(pred), _nchw(gt))


def test_ssim_functional_and_streaming_match_jax():
    pairs = [_pair(s) for s in (3, 4)]
    np.testing.assert_allclose(
        ssim.calculate_ssim(*map(_nchw, pairs[0])),
        jssim.calculate_ssim(*pairs[0]), rtol=TOL)
    np.testing.assert_allclose(
        ssim.calculate_ssim_per_image(*map(_nchw, pairs[1]), use_luma=True),
        jssim.calculate_ssim_per_image(*pairs[1], use_luma=True), rtol=TOL)
    got = ssim.evaluate_pairs_ssim([tuple(map(_nchw, p)) for p in pairs])
    want = jssim.evaluate_pairs_ssim(pairs)
    assert got["count"] == want["count"] == 4
    for k in ("ssim_mean", "ssim_std", "per_image"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
    metric, jmetric = ssim.SSIMMetric(), jssim.SSIMMetric()
    with pytest.raises(RuntimeError, match="before update"):
        metric.compute()
    for p in pairs:
        metric.update(*map(_nchw, p))
        jmetric.update(*p)
    np.testing.assert_allclose(metric.compute(), jmetric.compute(), rtol=TOL)
    metric.reset()
    assert metric._count == 0


def test_channelwise_matches_jax():
    pred, gt = _pair(5)
    p, g = _nchw(pred), _nchw(gt)
    got, want = channelwise.rgb_psnr(p, g), jcw.rgb_psnr(pred, gt)
    assert got["meta"] == want["meta"]
    for k in ("R", "G", "B", "mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    got, want = channelwise.cpsnr_rgb(p, g, data_range=2.0), jcw.cpsnr_rgb(
        pred, gt, data_range=2.0)
    np.testing.assert_allclose(got["cpsnr"], want["cpsnr"], rtol=TOL)
    np.testing.assert_allclose(got["channel_mse"], want["channel_mse"],
                               rtol=TOL)
    got, want = channelwise.rgb_ssim(p, g, domain="srgb"), jcw.rgb_ssim(
        pred, gt, domain="srgb")
    assert got["meta"] == want["meta"] == {"domain": "srgb",
                                           "data_range": 1.0}
    for k in ("R", "G", "B", "mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    assert channelwise.rgb_psnr(p, p)["mean"] == float("inf")
    with pytest.raises(ValueError, match="NCHW"):
        channelwise.rgb_psnr(p[:, :2], g[:, :2])


@pytest.mark.parametrize("data_range", [1.0, 255.0])
def test_calculate_psnr_matches_jax(data_range):
    pred, gt = _pair(6, hi=data_range)
    np.testing.assert_allclose(
        psnr.calculate_psnr(_nchw(gt), _nchw(pred), data_range=data_range),
        jpsnr.calculate_psnr(gt, pred, data_range=data_range), rtol=TOL)
    assert psnr.calculate_psnr(_nchw(gt), _nchw(gt)) == float("inf")
    with pytest.raises(ValueError, match="positive"):
        psnr.calculate_psnr(_nchw(gt), _nchw(pred), data_range=0)


@pytest.mark.parametrize("crop,y,uint8", [(0, False, False), (4, False, True),
                                          (0, True, True), (3, True, False)])
def test_psnr_ssim_img_match_jax(crop, y, uint8):
    pred, gt = _pair(7, n=1, h=40, w=36)
    pred, gt = pred[0], gt[0]
    if uint8:
        pred, gt = ((a * 255).round().astype(np.uint8) for a in (pred, gt))
    for port_fn, jax_fn in ((psnr_ssim_img.calculate_psnr_img,
                             jimg.calculate_psnr_img),
                            (psnr_ssim_img.calculate_ssim_img,
                             jimg.calculate_ssim_img)):
        got = port_fn(torch.from_numpy(np.ascontiguousarray(pred)), gt,
                      crop_border=crop, test_y_channel=y)
        want = jax_fn(pred, gt, crop_border=crop, test_y_channel=y)
        np.testing.assert_allclose(got, want, rtol=TOL)


def test_rgb2ycbcr_matches_jax():
    img = np.random.default_rng(8).uniform(0, 1, (6, 5, 3))
    for y_only in (False, True):
        np.testing.assert_allclose(psnr_ssim_img.rgb2ycbcr(img, y_only),
                                   jimg.rgb2ycbcr(img, y_only), rtol=TOL)


# --- physics consistency ----------------------------------------------------

_rng = np.random.default_rng(9)
PSFS = {
    "hw_3x3": _rng.uniform(0, 1, (3, 3)),
    "mono_1x5x5": _rng.uniform(0, 1, (1, 5, 5)),
    "depthwise_3x3x3": _rng.uniform(0, 1, (3, 3, 3)),
    "full_3x3x3x3": _rng.uniform(0, 1, (3, 3, 3, 3)),
    "full_3x1x3x5": _rng.uniform(-0.1, 1, (3, 1, 3, 5)),
}
EXPOS = {
    "scalar": 3.0,
    "per_image": np.array([2.0, 5.0], np.float32),
    "n111": np.array([2.0, 5.0], np.float32).reshape(2, 1, 1, 1),
    "map": None,   # a full map, drawn in the test
}


@pytest.mark.parametrize("padding", ["zero", "replicate", "reflect"])
@pytest.mark.parametrize("psf", sorted(PSFS))
def test_phys_consistency_matches_jax(padding, psf):
    i = sorted(PSFS).index(psf)
    expo_name = sorted(EXPOS)[i % len(EXPOS)]
    penalty = ("l1", "charbonnier")[i % 2]
    reduction = ("mean", "sum", "none")[i % 3]
    rng = np.random.default_rng(10 + i)
    bhat = rng.uniform(0, 1, (2, 12, 14, 3)).astype(np.float32)
    a = rng.uniform(0, 1, bhat.shape).astype(np.float32)
    expo = EXPOS[expo_name]
    if expo is None:
        expo = rng.uniform(1, 4, bhat.shape).astype(np.float32)
    kw = dict(padding=padding, penalty=penalty, reduction=reduction,
              clamp_nonneg=(i == 4))
    for port_fn, jax_fn in ((phys_consistency.phys_cons_raw,
                             jphys.phys_cons_raw),
                            (phys_consistency.phys_cons_srgb,
                             jphys.phys_cons_srgb)):
        e = torch.from_numpy(np.transpose(expo, (0, 3, 1, 2)).copy()) \
            if expo_name == "map" else expo
        got = port_fn(_nchw(bhat).requires_grad_(True), _nchw(a),
                      torch.from_numpy(np.asarray(PSFS[psf], np.float32)), e,
                      return_map=True, **kw)
        want = jax_fn(bhat, a, PSFS[psf], expo, return_map=True, **kw)
        assert not got["value"].requires_grad
        assert got["meta"] == want["meta"]
        for k in ("value", "per_sample"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(
            got["residual_map"].numpy(),
            np.transpose(np.asarray(want["residual_map"]), (0, 3, 1, 2)),
            rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            port_fn(_nchw(bhat), _nchw(a), PSFS[psf], e, **kw).numpy(),
            np.asarray(jax_fn(bhat, a, PSFS[psf], expo, **kw)),
            rtol=TOL, atol=TOL)


def test_phys_consistency_checks():
    x = torch.rand(2, 3, 8, 8)
    with pytest.raises(ValueError, match="odd"):
        phys_consistency.phys_cons_raw(x, x, np.ones((1, 2, 2)), 1.0)
    with pytest.raises(ValueError, match="incompatible"):
        phys_consistency.phys_cons_raw(x, x, np.ones((2, 3, 3)), 1.0)
    with pytest.raises(ValueError, match="exposure"):
        phys_consistency.phys_cons_raw(x, x, np.ones((3, 3)),
                                       np.ones(3, np.float32))
    with pytest.raises(ValueError, match="padding"):
        phys_consistency.phys_cons_raw(x, x, np.ones((3, 3)), 1.0,
                                       padding="wrap")
    k = np.zeros((3, 3, 3), np.float32)
    k[0, 1, 1] = 1.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        phys_consistency.phys_cons_raw(x, x, k, 1.0)
    assert any("zero energy" in str(w.message) for w in caught)


# --- NIQE --------------------------------------------------------------------

@pytest.mark.parametrize("params", ["niqe_pris_params.npz",
                                    "niqe_pris_params_photo.npz",
                                    "niqe_pris_params_synthetic.npz"])
def test_niqe_matches_jax(params):
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:200, 0:196] / 200.0
    img = np.clip(np.stack([np.sin(9 * xx), np.cos(7 * yy), xx * yy], -1)
                  * 0.4 + 0.5 + rng.normal(0, 0.03, (200, 196, 3)), 0, 1)
    img = (img * 255).astype(np.float32)
    path = str(niqe.PRIS_DIR / params)
    want = jniqe.calculate_niqe(img, pris_params_path=path)
    got = niqe.calculate_niqe(torch.from_numpy(img).permute(2, 0, 1),
                              pris_params_path=path)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        niqe.calculate_niqe(img[..., 0], pris_params_path=path,
                            crop_border=2),
        jniqe.calculate_niqe(img[..., 0], pris_params_path=path,
                             crop_border=2), rtol=1e-6)
    assert niqe.niqe_model_info(path)["corpus"] == \
        jniqe.niqe_model_info(path)["corpus"]


# --- compute_metrics ---------------------------------------------------------

KW = dict(img_channel=3, width=8, enc_blk_nums=(1, 2), middle_blk_num=1,
          dec_blk_nums=(1, 1))


@pytest.fixture(scope="module")
def bridged_net():
    jnet = JaxNAFNet(fused_blocks=False, flat_trunk=False, **KW)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(3),
                                 jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.default_rng(13)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, np.shape(a))).astype(
            np.float32), params)
    net = define_network({"type": "NewBPNAFNet", "in_channels": 3,
                          "nafnet_params": dict(KW)}, device="cpu")
    net.load_state_dict(params_from_jax(params, model=net), strict=True)
    return jnet, params, net.eval()


@pytest.fixture
def lpips_vgg_npz(tmp_path, monkeypatch):
    """One LPIPS-vgg weight file for both packages (the JAX random init,
    heads redrawn), through ``$LLIE_LPIPS_NPZ``; both model caches
    emptied."""
    _, variables, _ = jlpips(net="vgg")
    sd = lpips_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      variables), "vgg")
    rng = np.random.default_rng(14)
    arrays = {k: (v.numpy().reshape(-1) if k.startswith("lin") else
                  v.numpy()) for k, v in sd.items()}
    for k in arrays:
        if k.startswith("lin"):
            arrays[k] = rng.uniform(0, 0.2, arrays[k].shape).astype(
                np.float32)
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **arrays)
    monkeypatch.setenv("LLIE_LPIPS_NPZ", str(path))
    monkeypatch.setattr(JLPIPSMetric, "_CACHE", {})
    monkeypatch.setattr(lpips_metric, "_CACHE", {})
    return path


def _val_batches():
    out = []
    for s in (15, 16):
        rng = np.random.default_rng(s)
        gt = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        short = (gt / 4.0 + rng.normal(0, 0.01, gt.shape)).astype(np.float32)
        out.append({"lq": np.clip(short * 4.0, 0, 1).astype(np.float32),
                    "gt": gt, "short_raw": short,
                    "expo_ratio": np.array([4.0, 3.5], np.float32)})
    return out


@pytest.mark.parametrize("srgb_convert", [False, True])
def test_compute_metrics_matches_jax(bridged_net, lpips_vgg_npz,
                                     srgb_convert):
    jnet, params, net = bridged_net
    batches = _val_batches()
    psf = np.array([[0.01, 0.02, 0.01], [0.02, 0.88, 0.02],
                    [0.01, 0.02, 0.01]], np.float32)[None]
    kw = dict(psf_kernel=psf, use_lpips=True, lpips_net="vgg",
              srgb_convert=srgb_convert)
    want = jev.compute_metrics(
        lambda x: jnet.apply({"params": params}, x), batches, **kw)
    got = evaluation.compute_metrics(net, batches, device="cpu", **kw)
    assert set(got) == set(want) and {"lpips", "phys_mae"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    # NCHW tensors are taken as they are; max_batches stops early
    one = {k: (_nchw(v) if v.ndim == 4 else torch.from_numpy(v))
           for k, v in batches[0].items()}
    got1 = evaluation.compute_metrics(net, [one, one], device="cpu",
                                      max_batches=1, **kw)
    want1 = jev.compute_metrics(lambda x: jnet.apply({"params": params}, x),
                                batches[:1], **kw)
    for k in want1:
        np.testing.assert_allclose(got1[k], want1[k], rtol=1e-4, err_msg=k)
    assert evaluation.compute_metrics(net, [], device="cpu",
                                      use_lpips=False) == {}


# --- parameters, FLOPs, latency ---------------------------------------------

@pytest.mark.parametrize("unit", ["raw", "K", "M"])
def test_count_parameters_matches_jax(bridged_net, unit):
    _, params, net = bridged_net
    want = jpar.count_parameters(params, unit=unit)
    assert parameter_utils.count_parameters(net, unit=unit) == want
    assert parameter_utils.count_parameters(net.state_dict(), unit=unit) \
        == want
    assert parameter_utils.count_parameters(
        params_from_jax(params), unit=unit) == want
    with pytest.raises(ValueError, match="unit"):
        parameter_utils.count_parameters(net, unit="G")


def _analytic_macs(width, enc, mid, dec, h, w, c_in=3):
    """Multiply-adds of NAFNet's convolutions and products at (h, w)."""
    macs, c = 9 * c_in * width * h * w, width   # intro

    def block(c, hw):
        return hw * (c * 2 * c + 9 * 2 * c + c * c + c * 2 * c + c * c) \
            + c * c   # conv1, dw, conv3, conv4, conv5; the SCA 1x1

    for n in enc:
        macs += n * block(c, h * w)
        h, w = h // 2, w // 2
        macs += 4 * c * 2 * c * h * w            # 2x2/2 down conv
        c *= 2
    macs += mid * block(c, h * w)
    for n in dec:
        macs += c * 2 * c * h * w                # 1x1 up conv
        h, w, c = h * 2, w * 2, c // 2
        macs += n * block(c, h * w)
    return macs + 9 * c * c_in * h * w           # ending


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_count_flops_is_the_analytic_count(bridged_net, device):
    jnet, params, net = bridged_net
    want = _analytic_macs(8, (1, 2), 1, (1, 1), 32, 32)
    model = net if device == "cpu" else NAFNet(**KW).to("meta")
    x = torch.zeros(1, 3, 32, 32, device=device)
    res = flops_utils.FLOPsCounter().count(model, x, per_sample_batch=1)
    assert res.total == want and res.per_sample == want
    assert device in res.metadata["backend"]
    double = flops_utils.count_flops(model, x, convention="flops_2xmac")
    assert double["flops"] == 2 * want
    assert flops_utils.count_flops(model, x, convention="macs")["flops_M"] \
        == want / 1e6
    xla = jflops.FLOPsCounter().count(
        lambda p, a: jnet.apply({"params": p}, a), params,
        jnp.zeros((1, 32, 32, 3))).total
    assert res.total <= xla
    with pytest.raises(ValueError, match="convention"):
        flops_utils.FLOPsCounter(convention="gflops")


def test_measure_inference_time_keys():
    x = torch.rand(2, 3, 8, 8)
    res = inference_time.measure_inference_time(lambda a: a * 2, x,
                                                warmup=1, runs=3,
                                                batch_size=2)
    jres = __import__(
        "lowlight_image_enhancement_tpu.metrics.inference_time",
        fromlist=["x"]).measure_inference_time(lambda a: a * 2,
                                               jnp.asarray(x.numpy()),
                                               warmup=1, runs=3,
                                               batch_size=2)
    assert set(res) == set(jres)
    assert res["runs"] == 3.0 and res["batch_size"] == 2.0
    assert res["ms_per_image"] == pytest.approx(res["ms_per_batch"] / 2)
    with pytest.raises(ValueError):
        inference_time.measure_inference_time(lambda a: a, x, runs=0)
