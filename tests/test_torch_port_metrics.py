"""The port's validation metrics against the JAX package's, on the CPU:

- ``metrics/color_error.py`` (``deltaE2000_map``, ``deltaE2000_summary``,
  ``edge_deltaE2000``) on seeded NCHW images against the JAX functions on
  the same NHWC images: rtol 1e-5 (the map elementwise with an absolute
  floor of 1e-4, below the metric's 1e-3 resolution);
- every config bridge name of ``METRIC_REGISTRY`` (``linear_psnr``,
  ``linear_ssim``, ``deltae2000_mean``, ``deltae2000_p95``,
  ``edge_deltae2000_mean``) against the JAX registry's: rtol 1e-5;
- ``training/validation.py:compute_metrics`` over the flagship config's
  ``val.metrics`` block;
- the bridge names ``lpips_distance`` (one weight file for both
  packages), ``psnr`` and ``ssim`` (image domain) against the JAX
  registry's, and the input checks of the colour metrics.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lowlight_image_enhancement_tpu import metrics as jmetrics
from lowlight_image_enhancement_tpu.metrics import color_error as jce
from lowlight_image_enhancement_tpu.metrics.lpips_metric import (
    LPIPSMetric as JLPIPSMetric,
)
from lowlight_image_enhancement_tpu.models.lpips import load_lpips
from lowlight_image_enhancement_tpu.utils.registry import (
    METRIC_REGISTRY as JAX_METRICS,
)
from lowlight_image_enhancement_tpu_torch import metrics  # noqa: F401
from lowlight_image_enhancement_tpu_torch.metrics import color_error as ce
from lowlight_image_enhancement_tpu_torch.metrics import lpips_metric
from lowlight_image_enhancement_tpu_torch.training.validation import (
    compute_metrics,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import METRIC_REGISTRY
from lowlight_image_enhancement_tpu_torch.weights import lpips_params_from_jax

FLAGSHIP = "configs/sid_newbp_mono_selfcontained.yml"


def _pair(seed, n=2, h=24, w=32):
    """A smooth-ish target with edges and a noisy prediction, NHWC."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.tanh(8 * (xx - 0.5)), np.sin(6 * yy), xx * yy], -1)
    gt = np.clip(0.5 + 0.4 * base[None] + rng.normal(0, 0.05, (n, h, w, 3)),
                 0, 1).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.08, gt.shape), 0, 1).astype(
        np.float32)
    return pred, gt


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                             (0, 3, 1, 2))))


@pytest.mark.parametrize("seed", [0, 1])
def test_deltae_map_matches_jax(seed):
    pred, gt = _pair(seed)
    got = ce.deltaE2000_map(_nchw(pred), _nchw(gt)).numpy()
    want = np.asarray(jce.deltaE2000_map(pred, gt))
    assert got.shape == want.shape == pred.shape[:3]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_deltae_summary_matches_jax(seed):
    pred, gt = _pair(seed)
    got = ce.deltaE2000_summary(_nchw(pred), _nchw(gt),
                                percentiles=(50.0, 95.0))
    want = jce.deltaE2000_summary(pred, gt, percentiles=(50.0, 95.0))
    assert got["meta"] == want["meta"]
    for k in ("mean", "p50", "p95"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("q", [0.5, 0.85])
def test_edge_deltae_matches_jax(q):
    pred, gt = _pair(2)
    got = ce.edge_deltaE2000(_nchw(pred), _nchw(gt), edge_quantile=q)
    want = jce.edge_deltaE2000(pred, gt, edge_quantile=q)
    assert got["meta"] == want["meta"]
    for k in ("mean", "p95"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


BRIDGE = ["linear_psnr", "linear_ssim", "deltae2000_mean",
          "deltae2000_p95", "edge_deltae2000_mean"]


@pytest.mark.parametrize("name", BRIDGE)
def test_bridge_names_match_jax(name):
    pred, gt = _pair(3, h=32, w=40)
    kw = {"data_range": 1.0} if name.startswith("linear") else {}
    got = METRIC_REGISTRY.get(name)(_nchw(pred), _nchw(gt), **kw)
    want = JAX_METRICS.get(name)(jnp.asarray(pred), jnp.asarray(gt), **kw)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)


def test_compute_metrics_on_the_flagship_block():
    with open(FLAGSHIP) as f:
        metrics_opt = yaml.safe_load(f)["val"]["metrics"]
    pred, gt = _pair(4, n=1, h=32, w=32)
    got = compute_metrics(_nchw(pred), _nchw(gt), metrics_opt)
    assert set(got) == set(metrics_opt)
    for name, opt in metrics_opt.items():
        opt = dict(opt)
        fn = JAX_METRICS.get(opt.pop("type"))
        np.testing.assert_allclose(got[name], float(fn(pred, gt, **opt)),
                                   rtol=1e-5, err_msg=name)


@pytest.fixture
def same_lpips_alex(tmp_path, monkeypatch):
    """One LPIPS-alex weight file (the JAX random init) read by both
    packages through ``$LLIE_LPIPS_NPZ``, their model caches emptied."""
    _, variables, _ = load_lpips(net="alex")
    sd = lpips_params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), "alex")
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    monkeypatch.setenv("LLIE_LPIPS_NPZ", str(path))
    monkeypatch.setattr(JLPIPSMetric, "_CACHE", {})
    monkeypatch.setattr(lpips_metric, "_CACHE", {})


@pytest.mark.parametrize("name,kw", [
    ("lpips_distance", {}),
    ("psnr", {"crop_border": 2, "test_y_channel": True}),
    ("ssim", {"crop_border": 1}),
])
def test_image_and_lpips_bridge_names_match_jax(same_lpips_alex, name, kw):
    """The names that waited for the rest of ``metrics/`` (LPIPS, the
    image-domain PSNR/SSIM) against the JAX registry's: rtol 1e-5 (LPIPS
    1e-4, as the LPIPS tests hold it)."""
    pred, gt = _pair(5, h=64, w=48)
    got = METRIC_REGISTRY.get(name)(_nchw(pred), _nchw(gt), **kw)
    want = JAX_METRICS.get(name)(jnp.asarray(pred), jnp.asarray(gt), **kw)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, float(want),
                               rtol=1e-4 if name.startswith("lpips")
                               else 1e-5)


def test_colour_metric_input_checks():
    pred, gt = (_nchw(a) for a in _pair(6))
    with pytest.raises(ValueError, match="shape"):
        ce.deltaE2000_map(pred, gt[:, :, :10])
    with pytest.raises(ValueError, match="NCHW"):
        ce.deltaE2000_map(pred[:, :2], gt[:, :2])
    bad = pred.clone()
    bad[0, 0, 0, 0] = float("nan")
    with pytest.raises(ValueError, match="finite"):
        ce.deltaE2000_summary(bad, gt)
    with pytest.raises(ValueError, match="edge_quantile"):
        ce.edge_deltaE2000(pred, gt, edge_quantile=1.0)
    with pytest.raises(ValueError, match="whitepoint"):
        ce.deltaE2000_map(pred, gt, whitepoint="A")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ce.deltaE2000_map(pred, gt, whitepoint="D50")
    assert any("D50" in str(w.message) for w in caught)
    # a flat target has no edges above the quantile but its own pixels
    flat = torch.full_like(gt, 0.5)
    out = ce.edge_deltaE2000(pred, flat)
    want = jce.edge_deltaE2000(np.transpose(pred.numpy(), (0, 2, 3, 1)),
                               np.transpose(flat.numpy(), (0, 2, 3, 1)))
    np.testing.assert_allclose(out["mean"], want["mean"], rtol=1e-5)
    assert jmetrics is not None
